"""End-to-end generation-quality evaluation runner.

Equivalent of the reference's evaluation notebook
(notebooks/evaluation.ipynb): run the RAG system over a QA set (the
70-question NICEQA CSV format: Guideline ID, Section, Question), collect
answers + retrieved contexts, score with Faithfulness + ResponseRelevancy
(judge LLM + judge embeddings), and write per-sample and aggregate CSVs.
Also supports the LLM-only baseline (no retrieval) for the comparison
rows in BASELINE.md.
"""

from __future__ import annotations

import argparse
import csv
import logging
import math
import os
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


def load_niceqa_csv(path: str) -> List[Dict]:
    with open(path, "r", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def collect_rag_answers(
    rag_system,
    questions: List[str],
    llm_model: str,
    model_weights: Optional[Dict[str, float]] = None,
    use_hybrid_search: bool = True,
    use_reranker: bool = True,
    reranker_top_k: int = 10,
) -> List[Dict]:
    """Run each question through query_rag_stream; returns evaluation rows
    (user_input, response, retrieved_contexts)."""
    rows = []
    for q in questions:
        chunks, raw = [], ""
        for chunk, _, raw, _ in rag_system.query_rag_stream(
            q,
            llm_model,
            model_weights=model_weights,
            use_hybrid_search=use_hybrid_search,
            use_reranker=use_reranker,
            reranker_top_k=reranker_top_k,
        ):
            chunks.append(chunk)
        contexts = raw.split("\n\n--- Context Chunk ---\n\n") if raw else []
        rows.append(
            {
                "user_input": q,
                "response": "".join(chunks),
                "retrieved_contexts": contexts,
            }
        )
    return rows


def collect_baseline_answers(
    chat_client, questions: List[str], llm_model: str
) -> List[Dict]:
    """LLM-only baseline: no retrieval, question asked directly."""
    rows = []
    for q in questions:
        text = "".join(
            chat_client.stream_chat(
                llm_model, [{"role": "user", "content": q}], temperature=0
            )
        )
        rows.append(
            {"user_input": q, "response": text, "retrieved_contexts": [""]}
        )
    return rows


def score_rows(
    rows: List[Dict],
    judge_llm,
    judge_embeddings,
    metrics: Optional[List] = None,
    show_progress: bool = True,
):
    from a_nice_rag_tpu_torch.evals.ragas import EvaluationDataset, evaluate
    from a_nice_rag_tpu_torch.evals.ragas.metrics import (
        Faithfulness,
        ResponseRelevancy,
    )

    dataset = EvaluationDataset.from_list(rows)
    metrics = metrics or [Faithfulness(), ResponseRelevancy()]
    return evaluate(
        dataset,
        metrics,
        llm=judge_llm,
        embeddings=judge_embeddings,
        show_progress=show_progress,
    )


def write_results_csv(
    result, llm_model: str, output: str, per_sample_output: Optional[str] = None
) -> None:
    agg = result.aggregate()
    exists = os.path.exists(output)
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    with open(output, "a", encoding="utf-8", newline="") as f:
        writer = csv.writer(f)
        if not exists:
            writer.writerow(["llm_model"] + list(agg.keys()))
        writer.writerow([llm_model] + [f"{v:.4f}" for v in agg.values()])
    if per_sample_output:
        write_per_sample_csv(result, per_sample_output)


def _csv_cell(value) -> str:
    """One cell as pandas' ``to_csv`` writes it: None and NaN empty,
    floats in their repr, everything else through ``str``."""
    if value is None:
        return ""
    if isinstance(value, float):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def write_per_sample_csv(result, path: str) -> None:
    """Per-sample rows (the dataset's columns, then one per metric), the
    table ``result.to_pandas().to_csv(path, index=False)`` writes, with
    the csv module instead of pandas."""
    if result.dataset is not None:
        rows = [s.model_dump() for s in result.dataset.samples]
    else:
        rows = [{} for _ in result.scores]
    columns = list(rows[0]) if rows else []
    for name, vals in result._scores_dict.items():
        if name not in columns:
            columns.append(name)
        for row, value in zip(rows, vals):
            row[name] = value
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_cell(row.get(c)) for c in columns])


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--qa-csv", required=True, help="NICEQA-format CSV")
    p.add_argument("--question-column", default="Question")
    p.add_argument("--llm-model", default="gpt-4.1-mini")
    p.add_argument("--judge-model", default="gpt-4.1-mini")
    p.add_argument("--baseline", action="store_true", help="LLM-only, no RAG")
    p.add_argument("--output", default="results/ragas_evaluation_results.csv")
    p.add_argument("--per-sample-output", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the RAG system's index (cpu or cuda)")
    args = p.parse_args(argv)

    from a_nice_rag_tpu_torch.evals.ragas.llm import OpenAICompatJudgeLLM
    from a_nice_rag_tpu_torch.evals.ragas.embeddings import EmbedderJudgeEmbeddings
    from a_nice_rag_tpu_torch.rag import RAGSystem, build_default_clients
    from a_nice_rag_tpu_torch.retrieval.embed import OpenAIEmbedder

    questions = [
        r[args.question_column] for r in load_niceqa_csv(args.qa_csv)
    ]
    judge = OpenAICompatJudgeLLM(model=args.judge_model)
    judge_emb = EmbedderJudgeEmbeddings(
        OpenAIEmbedder(model="text-embedding-3-small")
    )
    if args.baseline:
        clients = build_default_clients()
        rows = collect_baseline_answers(
            clients["openai"], questions, args.llm_model
        )
    else:
        rows = collect_rag_answers(
            RAGSystem(device=args.device), questions, args.llm_model
        )
    result = score_rows(rows, judge, judge_emb)
    write_results_csv(
        result, args.llm_model, args.output, args.per_sample_output
    )
    print(result)


if __name__ == "__main__":
    main()
