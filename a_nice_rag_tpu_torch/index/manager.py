"""Memoized index and artifact loading (counterpart of
``a_nice_rag_tpu/index/manager.py``; reference src/database_manager.py):
lock-guarded caches so concurrent sessions share one device-resident
index per path, plus the url-column migration helper
(notebooks/modify_db.ipynb cell 2 equivalent).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, Optional, Tuple

from a_nice_rag_tpu_torch.device import DeviceLike, resolve_device
from a_nice_rag_tpu_torch.index.array_index import ArrayIndex
from a_nice_rag_tpu_torch.index.io import (
    load_index,
    load_reference_chunk_db,
    load_reference_query_db,
)


class IndexManager:
    """Process-wide caches keyed by path; loads happen once. Artifacts
    load onto ``device`` (the card unless the caller passes another)."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._indexes: Dict[str, ArrayIndex] = {}
        self._chunk_dbs: Dict[str, Tuple] = {}
        self._query_dbs: Dict[str, Tuple] = {}

    def load_artifact(self, path: str) -> ArrayIndex:
        with self._lock:
            if path not in self._indexes:
                self._indexes[path] = load_index(path, device=self.device)
            return self._indexes[path]

    def load_chunk_db(self, path: str) -> Tuple:
        with self._lock:
            if path not in self._chunk_dbs:
                self._chunk_dbs[path] = load_reference_chunk_db(path)
            return self._chunk_dbs[path]

    def load_query_db(self, path: str) -> Tuple:
        with self._lock:
            if path not in self._query_dbs:
                self._query_dbs[path] = load_reference_query_db(path)
            return self._query_dbs[path]

    def invalidate(self, path: Optional[str] = None) -> None:
        with self._lock:
            if path is None:
                self._indexes.clear()
                self._chunk_dbs.clear()
                self._query_dbs.clear()
            else:
                for cache in (self._indexes, self._chunk_dbs, self._query_dbs):
                    cache.pop(path, None)


def add_url_column(
    db_path: str,
    url_template: str = "https://www.nice.org.uk/guidance/{source}",
) -> int:
    """Schema migration: add/populate the url column on a reference-format
    chunk DB. Returns the number of rows updated; idempotent."""
    conn = sqlite3.connect(db_path)
    try:
        cols = {r[1] for r in conn.execute("PRAGMA table_info(chunks)")}
        if "url" not in cols:
            conn.execute("ALTER TABLE chunks ADD COLUMN url TEXT")
        rows = conn.execute(
            "SELECT id, source FROM chunks WHERE url IS NULL"
        ).fetchall()
        for cid, source in rows:
            conn.execute(
                "UPDATE chunks SET url = ? WHERE id = ?",
                (url_template.format(source=str(source).lower()), cid),
            )
        conn.commit()
        return len(rows)
    finally:
        conn.close()
