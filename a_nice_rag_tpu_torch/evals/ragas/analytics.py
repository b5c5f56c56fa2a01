"""Usage analytics (ragas_modified/_analytics.py surface).

The reference batches usage events to a vendor endpoint with a
RAGAS_DO_NOT_TRACK opt-out. This framework keeps the event/opt-out API
but records events to a local JSONL file only — there is no network
telemetry. Set ANR_DO_NOT_TRACK=true (default honored the same way) to
disable recording entirely.
"""

from __future__ import annotations

import json
import os
import time
import threading
from typing import Dict, Optional

_OPT_OUT_VAR = "ANR_DO_NOT_TRACK"
_lock = threading.Lock()


def do_not_track() -> bool:
    return os.environ.get(_OPT_OUT_VAR, "").lower() in ("1", "true", "yes")


class AnalyticsEvent(Dict):
    pass


def track(
    event_type: str,
    properties: Optional[Dict] = None,
    log_path: str = ".cache/anr_usage_events.jsonl",
) -> bool:
    """Record one usage event locally; returns whether it was recorded."""
    if do_not_track():
        return False
    event = {
        "event": event_type,
        "ts": time.time(),
        **(properties or {}),
    }
    with _lock:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
        with open(log_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(event) + "\n")
    return True
