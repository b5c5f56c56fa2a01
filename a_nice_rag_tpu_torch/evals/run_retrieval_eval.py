"""CLI benchmark runner (reference src/retrieval_eval.py:122-432;
counterpart of ``a_nice_rag_tpu/evals/run_retrieval_eval.py``).

Loads per-model query-embedding DBs (reference SQLite format) and the
preprocessed BM25 token CSV, applies the seed-42 split (evaluating the
85% partition, as the reference does), and runs the 9 standard
configurations against an index artifact loaded onto ``--device`` (the
card unless ``--device cpu``), appending to a results CSV.

Usage:
    python -m a_nice_rag_tpu_torch.evals.run_retrieval_eval \
        --index artifacts/nice_index \
        --queries-db voyage-3-large=databases/voyage_3_large_suggested_queries_2048.db \
        --bm25-queries data/suggested_queries_bm25_preprocessed.csv \
        --output results/retrieval_evaluation_results.csv [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, List

import numpy as np

from a_nice_rag_tpu_torch.evals.retrieval_eval import (
    RetrievalEvaluator,
    STANDARD_CONFIGURATIONS,
    seed42_split,
)
from a_nice_rag_tpu_torch.index import load_index
from a_nice_rag_tpu_torch.index.io import (
    load_preprocessed_tokens_csv,
    load_reference_query_db,
)
from a_nice_rag_tpu_torch.retrieval import SearchEngine, VoyageReranker

logger = logging.getLogger(__name__)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--index", required=True)
    p.add_argument(
        "--queries-db",
        action="append",
        default=[],
        help="model=path pairs for reference-format query DBs",
    )
    p.add_argument("--bm25-queries", default=None)
    p.add_argument("--output", default="results/retrieval_evaluation_results.csv")
    p.add_argument("--filter", default="CG,NG")
    p.add_argument("--wrrf-k", type=float, default=40.0)
    p.add_argument("--no-split", action="store_true",
                   help="evaluate all queries instead of the 85%% partition")
    p.add_argument("--with-rerank-api", action="store_true",
                   help="enable the external rerank API configs")
    p.add_argument("--device", default="cuda",
                   help="torch device the index is loaded onto")
    args = p.parse_args(argv)

    index = load_index(args.index, device=args.device)
    reranker = None
    if args.with_rerank_api:
        reranker = VoyageReranker()
    evaluator = RetrievalEvaluator(
        index, SearchEngine(index, reranker=reranker)
    )

    query_embeddings: Dict[str, np.ndarray] = {}
    ids_by_model: Dict[str, List[str]] = {}
    texts = None
    for pair in args.queries_db:
        model, path = pair.split("=", 1)
        qids, qtexts, qemb = load_reference_query_db(path)
        query_embeddings[model] = qemb
        ids_by_model[model] = qids
        if texts is None:
            texts, gold_ids = qtexts, qids
    if not query_embeddings:
        raise SystemExit("at least one --queries-db is required")

    # Align all models to the first model's query-id order.
    base_ids = next(iter(ids_by_model.values()))
    for model, qids in ids_by_model.items():
        if qids != base_ids:
            pos = {q: i for i, q in enumerate(qids)}
            order = [pos[q] for q in base_ids if q in pos]
            query_embeddings[model] = query_embeddings[model][order]

    token_lists = None
    if args.bm25_queries:
        table = load_preprocessed_tokens_csv(args.bm25_queries)
        token_lists = [table.get(q, []) for q in base_ids]

    if not args.no_split:
        eval_idx, _ = seed42_split(len(base_ids))
        gold_ids = [base_ids[i] for i in eval_idx]
        texts = [texts[i] for i in eval_idx]
        query_embeddings = {m: v[eval_idx] for m, v in query_embeddings.items()}
        if token_lists is not None:
            token_lists = [token_lists[i] for i in eval_idx]
    else:
        gold_ids = base_ids

    configs = [
        c
        for c in STANDARD_CONFIGURATIONS
        if args.with_rerank_api or not c.use_reranker
    ]
    results = evaluator.run(
        configs,
        query_embeddings,
        gold_ids,
        query_token_lists=token_lists,
        query_texts=texts,
        filename_type_filter=args.filter,
        wrrf_k=args.wrrf_k,
        output_csv=args.output,
    )
    for name, m in results.items():
        print(
            f"{name}: MRR={m['mrr']:.3f} R@1={m['recall@1']:.3f} "
            f"R@10={m['recall@10']:.3f} R@15={m['recall@15']:.3f}"
        )


if __name__ == "__main__":
    main()
