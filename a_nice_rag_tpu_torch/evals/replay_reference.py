"""One-command §6.1 replay: reference on-disk artifacts -> results CSV
(counterpart of ``a_nice_rag_tpu/evals/replay_reference.py``).

Composes the two migration/eval stages end to end (they also exist as
separate CLIs):

1. ``ingest.import_reference`` — per-model chunk DBs + BM25 pickle ->
   native array-index artifact (bit-compatible BM25 stats).
2. ``evals.run_retrieval_eval`` — reference query DBs + preprocessed
   BM25 query CSV -> the 9-configuration benchmark CSV, seed-42 85%
   split, matching the reference's protocol
   (reference src/retrieval_eval.py:122-432 and its
   results/retrieval_evaluation_results.csv).

Both stages run on ``--device`` (the card unless ``--device cpu``).

When the reference's real (non-redistributable) databases are present,
this reproduces its §6.1 table row for row:

    python -m a_nice_rag_tpu_torch.evals.replay_reference \
        --chunk-db voyage-3-large=databases/voyage_3_large_nice_guidelines_2048.db \
        --bm25-pickle databases/bm25_index_nice_guidelines.pkl \
        --queries-db voyage-3-large=databases/voyage_3_large_suggested_queries_2048.db \
        --bm25-queries data/suggested_queries_bm25_preprocessed.csv \
        --workdir artifacts/replay \
        --output results/retrieval_evaluation_results.csv [--device cuda]

The pipeline is tested against generated reference-format fixtures
(testing.reference_fixture) since the real DBs cannot ship.
"""

from __future__ import annotations

import argparse
import logging
import os

from a_nice_rag_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--chunk-db", action="append", required=True,
                   help="model=path pairs (reference chunk DBs)")
    p.add_argument("--bm25-pickle", default=None)
    p.add_argument("--queries-db", action="append", required=True,
                   help="model=path pairs (reference query DBs)")
    p.add_argument("--bm25-queries", default=None,
                   help="preprocessed BM25 query CSV")
    p.add_argument("--workdir", required=True,
                   help="directory for the intermediate index artifact")
    p.add_argument("--output",
                   default="results/retrieval_evaluation_results.csv")
    p.add_argument("--filter", default="CG,NG")
    p.add_argument("--wrrf-k", type=float, default=40.0)
    p.add_argument("--no-split", action="store_true")
    p.add_argument("--with-rerank-api", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of both stages")
    args = p.parse_args(argv)
    resolve_device(args.device)  # no GPU: raise before writing anything

    from a_nice_rag_tpu_torch.index import save_index
    from a_nice_rag_tpu_torch.ingest.import_reference import (
        assemble_index_from_reference,
    )

    os.makedirs(args.workdir, exist_ok=True)
    artifact = os.path.join(args.workdir, "index")
    chunk_dbs = dict(pair.split("=", 1) for pair in args.chunk_db)
    index = assemble_index_from_reference(chunk_dbs, args.bm25_pickle,
                                          device=args.device)
    save_index(index, artifact)
    logger.info("stage 1: imported %d docs (%d models, bm25=%s) -> %s",
                index.n_docs, len(index.dense), index.bm25 is not None,
                artifact)

    del index
    from a_nice_rag_tpu_torch.evals.run_retrieval_eval import (
        main as eval_main,
    )

    eval_argv = ["--index", artifact, "--output", args.output,
                 "--filter", args.filter, "--wrrf-k", str(args.wrrf_k),
                 "--device", args.device]
    for pair in args.queries_db:
        eval_argv += ["--queries-db", pair]
    if args.bm25_queries:
        eval_argv += ["--bm25-queries", args.bm25_queries]
    if args.no_split:
        eval_argv += ["--no-split"]
    if args.with_rerank_api:
        eval_argv += ["--with-rerank-api"]
    eval_main(eval_argv)
    logger.info("stage 2: results appended to %s", args.output)


if __name__ == "__main__":
    main()
