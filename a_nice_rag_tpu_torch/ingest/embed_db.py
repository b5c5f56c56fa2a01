"""Embedding intake: chunks -> embedded corpus artifacts.

Equivalent of the reference DB builder (src/processing/create_database.py):
batched document embedding (Voyage input_type="document" dim 2048, or
OpenAI), INCREMENTAL by chunk id (already-embedded chunks are skipped so
interrupted runs resume), writable both as a reference-format SQLite
chunk DB and directly as the framework's array-index artifact.

Counterpart of ``a_nice_rag_tpu/ingest/embed_db.py``: the same SQLite rows,
and an artifact built on the device the caller names (the card unless
asked otherwise) and saved in the format both packages read.
"""

from __future__ import annotations

import logging
import os
import sqlite3
from typing import Dict, List, Optional, Sequence

import numpy as np

from a_nice_rag_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)


def existing_chunk_ids(db_path: str) -> set:
    if not os.path.exists(db_path):
        return set()
    conn = sqlite3.connect(db_path)
    try:
        return {r[0] for r in conn.execute("SELECT id FROM chunks")}
    except sqlite3.OperationalError:
        return set()
    finally:
        conn.close()


def write_chunk_db(
    db_path: str,
    ids: Sequence[str],
    contents: Sequence[str],
    sources: Sequence[str],
    embeddings: np.ndarray,
    urls: Optional[Sequence[str]] = None,
) -> None:
    """Append rows to a reference-format SQLite chunk DB (float32 blobs,
    schema of create_database.py:57-66 + the url column added by the
    reference's modify_db migration)."""
    os.makedirs(os.path.dirname(db_path) or ".", exist_ok=True)
    conn = sqlite3.connect(db_path)
    try:
        conn.execute(
            "CREATE TABLE IF NOT EXISTS chunks ("
            "id TEXT PRIMARY KEY, content TEXT, source TEXT, "
            "embedding BLOB, url TEXT)"
        )
        for i, cid in enumerate(ids):
            conn.execute(
                "INSERT OR REPLACE INTO chunks VALUES (?,?,?,?,?)",
                (
                    cid,
                    contents[i],
                    sources[i],
                    np.asarray(embeddings[i], np.float32).tobytes(),
                    urls[i] if urls else None,
                ),
            )
        conn.commit()
    finally:
        conn.close()


def embed_chunks_incremental(
    chunks: Sequence[Dict],
    embedder,
    db_path: str,
    batch_size: int = 100,
    url_template: str = "https://www.nice.org.uk/guidance/{source}",
) -> int:
    """Embed chunk dicts ({title, content, source}) into a chunk DB,
    skipping ids already present. Returns the number newly embedded."""
    done = existing_chunk_ids(db_path)
    todo = [c for c in chunks if c["title"] not in done]
    logger.info("%d chunks to embed (%d already present)", len(todo), len(done))
    written = 0
    for start in range(0, len(todo), batch_size):
        batch = todo[start : start + batch_size]
        emb = embedder.embed_documents([c["content"] for c in batch])
        write_chunk_db(
            db_path,
            ids=[c["title"] for c in batch],
            contents=[c["content"] for c in batch],
            sources=[c["source"] for c in batch],
            embeddings=emb,
            urls=[
                url_template.format(source=c["source"].lower()) for c in batch
            ],
        )
        written += len(batch)
        logger.info("embedded %d/%d", written, len(todo))
    return written


def build_artifact_from_chunk_dbs(
    db_paths: Dict[str, str],
    artifact_path: str,
    token_lists_by_id: Optional[Dict[str, List[str]]] = None,
    k1: float = 1.7,
    b: float = 0.83,
    epsilon: float = 0.05,
    device: DeviceLike = "cuda",
) -> None:
    """Assemble the array-index artifact from one or more reference-format
    chunk DBs (one per embedding model) + optional BM25 token lists. The
    index is built on ``device`` before it is saved."""
    from a_nice_rag_tpu_torch.index import build_index, save_index
    from a_nice_rag_tpu_torch.index.io import load_reference_chunk_db

    base_model = next(iter(db_paths))
    ids, contents, sources, urls, emb = load_reference_chunk_db(
        db_paths[base_model]
    )
    embeddings = {base_model: emb}
    for model, path in db_paths.items():
        if model == base_model:
            continue
        m_ids, _, _, _, m_emb = load_reference_chunk_db(path)
        pos = {cid: i for i, cid in enumerate(m_ids)}
        rows = [pos.get(cid, -1) for cid in ids]
        aligned = np.zeros((len(ids), m_emb.shape[1]), np.float32)
        for i, r in enumerate(rows):
            if r >= 0:
                aligned[i] = m_emb[r]
        embeddings[model] = aligned
    token_lists = None
    if token_lists_by_id is not None:
        token_lists = [token_lists_by_id.get(cid, []) for cid in ids]
    index = build_index(
        ids=ids,
        sources=sources,
        contents=contents,
        urls=urls,
        embeddings=embeddings,
        token_lists=token_lists,
        k1=k1,
        b=b,
        epsilon=epsilon,
        device=device,
    )
    save_index(index, artifact_path)
