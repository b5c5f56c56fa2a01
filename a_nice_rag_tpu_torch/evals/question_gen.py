"""Synthetic evaluation-query generation.

Equivalent of the reference's question_generation notebook
(notebooks/question_generation.ipynb): filter chunks to CG/NG
guidelines, drop boilerplate sections (committee/appendix/update
patterns) and very short chunks, generate one synthetic clinical query
per chunk with a chat LLM (bounded-concurrency batches), and store
(id, query, query_embedding) into reference-format SQLite query DBs so
the retrieval benchmark can run offline.
"""

from __future__ import annotations

import logging
import re
import sqlite3
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

BOILERPLATE_PATTERNS = [
    r"committee",
    r"appendix",
    r"update information",
    r"finding more information",
    r"context$",
    r"recommendations for research",
]

QUESTION_PROMPT = (
    "You are generating evaluation data for a clinical-guideline search "
    "engine. Write ONE natural question a clinician or patient might ask "
    "whose answer is contained in the following guideline excerpt. Reply "
    "with only the question.\n\nExcerpt:\n{chunk}"
)


def filter_chunks(
    chunks: Sequence[Dict],
    prefixes: Sequence[str] = ("CG", "NG"),
    min_chars: int = 100,
) -> List[Dict]:
    """CG/NG filter + boilerplate-section and short-chunk removal."""
    out = []
    pats = [re.compile(p, re.IGNORECASE) for p in BOILERPLATE_PATTERNS]
    for c in chunks:
        if not c.get("source", "").upper().startswith(tuple(prefixes)):
            continue
        if len(c.get("content", "")) < min_chars:
            continue
        title = c.get("title", "")
        if any(p.search(title) for p in pats):
            continue
        out.append(c)
    return out


def generate_questions(
    chunks: Sequence[Dict],
    chat_client,
    llm_model: str = "gpt-4.1-nano",
    max_workers: int = 16,
) -> List[Dict]:
    """One (chunk id, question) pair per chunk via thread fan-out."""

    def one(chunk: Dict) -> Dict:
        prompt = QUESTION_PROMPT.format(chunk=chunk["content"][:4000])
        text = "".join(
            chat_client.stream_chat(
                llm_model, [{"role": "user", "content": prompt}], temperature=0.7
            )
        )
        return {"id": chunk["title"], "query": text.strip()}

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(one, chunks))


def write_query_db(
    db_path: str,
    rows: Sequence[Dict],
    embeddings: Optional[np.ndarray] = None,
) -> None:
    """Reference-format queries DB: queries(id, query, query_embedding)."""
    os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
    conn = sqlite3.connect(db_path)
    try:
        conn.execute(
            "CREATE TABLE IF NOT EXISTS queries "
            "(id TEXT, query TEXT, query_embedding BLOB)"
        )
        for i, row in enumerate(rows):
            blob = (
                np.asarray(embeddings[i], np.float32).tobytes()
                if embeddings is not None
                else None
            )
            conn.execute(
                "INSERT INTO queries VALUES (?,?,?)",
                (row["id"], row["query"], blob),
            )
        conn.commit()
    finally:
        conn.close()


def embed_and_store_queries(
    rows: Sequence[Dict],
    embedders: Dict[str, object],
    db_path_template: str = "databases/{model}_suggested_queries.db",
    batch_size: int = 100,
) -> None:
    """Embed generated queries with each model and store per-model DBs."""
    texts = [r["query"] for r in rows]
    for model, embedder in embedders.items():
        embs = []
        for start in range(0, len(texts), batch_size):
            embs.append(
                embedder.embed_queries(texts[start : start + batch_size])
            )
        emb = np.concatenate(embs) if embs else np.zeros((0, 0), np.float32)
        path = db_path_template.format(model=model.replace("/", "_"))
        write_query_db(path, rows, emb)
        logger.info("wrote %d queries for %s -> %s", len(rows), model, path)
