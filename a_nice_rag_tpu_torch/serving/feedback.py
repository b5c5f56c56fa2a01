"""User feedback log (reference src/app.py:36-58): thumbs up/down per
query appended to a JSON file, with timestamps."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class FeedbackLog:
    def __init__(self, path: str = "feedback/query_feedback.json"):
        self.path = path

    def _read(self) -> List[Dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                data = json.load(f)
            return data if isinstance(data, list) else []
        except (OSError, ValueError):
            return []

    def record(
        self,
        query: str,
        response: str,
        rating: str,
        llm_model: Optional[str] = None,
        sources: Optional[List[Dict]] = None,
    ) -> Dict:
        entry = {
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "query": query,
            "response": response,
            "rating": rating,  # "up" / "down"
            "llm_model": llm_model,
            "sources": sources or [],
        }
        entries = self._read()
        entries.append(entry)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", encoding="utf-8") as f:
            json.dump(entries, f, indent=1)
        return entry

    def entries(self) -> List[Dict]:
        return self._read()
