"""NICE guidance API downloader.

Equivalent of the reference download stage (src/processing/
nice_api_script.py): fetch the guidance index, then each guideline's
structured-document XML, writing ``{number}_structured_document.xml``
files, with a politeness delay and per-status-code error handling.
Requires the ``NICE_API_KEY`` environment variable; network access is
deployment-dependent, so everything is wrapped for graceful failure.

Counterpart of ``a_nice_rag_tpu/ingest/nice_api.py`` (a copy: it imports no
jax).
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

API_BASE = "https://api.nice.org.uk/services/guidance"


def _get(url: str, api_key: str, accept: str = "application/json") -> bytes:
    req = urllib.request.Request(
        url, headers={"API-Key": api_key, "Accept": accept}
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def fetch_guidance_index(api_key: Optional[str] = None) -> List[Dict]:
    """The published-guidance index (current.json)."""
    api_key = api_key or os.environ["NICE_API_KEY"]
    raw = _get(f"{API_BASE}/current.json", api_key)
    data = json.loads(raw.decode("utf-8"))
    return data if isinstance(data, list) else data.get("Guidance", data)


def download_guideline_xml(
    number: str, out_dir: str, api_key: Optional[str] = None
) -> Optional[str]:
    """One guideline's structured document; returns the file path."""
    api_key = api_key or os.environ["NICE_API_KEY"]
    url = f"{API_BASE}/{number.lower()}/structured-document.xml"
    try:
        raw = _get(url, api_key, accept="application/xml")
    except urllib.error.HTTPError as e:
        if e.code == 404:
            logger.warning("%s: no structured document (404)", number)
        elif e.code == 401:
            logger.error("%s: unauthorized - check NICE_API_KEY", number)
        elif e.code == 429:
            logger.warning("%s: rate limited (429) - slow down", number)
        else:
            logger.error("%s: HTTP %s", number, e.code)
        return None
    except urllib.error.URLError as e:
        logger.error("%s: network error %s", number, e.reason)
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{number}_structured_document.xml")
    with open(path, "wb") as f:
        f.write(raw)
    return path


def download_all(
    numbers: List[str],
    out_dir: str,
    api_key: Optional[str] = None,
    delay_s: float = 0.5,
    skip_existing: bool = True,
) -> Dict[str, Optional[str]]:
    """Download a set of guidelines with a politeness delay; idempotent
    (existing files are skipped, making interrupted runs resumable)."""
    results: Dict[str, Optional[str]] = {}
    for number in numbers:
        path = os.path.join(out_dir, f"{number}_structured_document.xml")
        if skip_existing and os.path.exists(path):
            results[number] = path
            continue
        results[number] = download_guideline_xml(number, out_dir, api_key)
        time.sleep(delay_s)
    return results
