"""Helicone observability-proxy configuration.

Equivalent of ragas_modified/integrations/helicone.py: a configuration
singleton that rewrites the judge base URL through the Helicone proxy
and carries the auth/cache headers. No helicone package exists — the
integration is pure configuration, as upstream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class CacheConfig:
    ttl: int = 60 * 60 * 24 * 30
    maxsize: int = 1000


@dataclass
class HeliconeSingleton:
    api_key: Optional[str] = None
    base_url: str = "https://oai.helicone.ai"
    cache_config: Optional[CacheConfig] = None
    _default_headers: Dict[str, str] = field(default_factory=dict)

    def default_headers(self) -> Dict[str, str]:
        if not self.api_key:
            raise ValueError("HeliconeSingleton.api_key not set")
        headers = {"Helicone-Auth": f"Bearer {self.api_key}"}
        if self.cache_config:
            headers["Helicone-Cache-Enabled"] = "true"
            headers["Cache-Control"] = f"max-age={self.cache_config.ttl}"
        headers.update(self._default_headers)
        return headers

    def judge_base_url(self) -> str:
        """Base URL for OpenAICompatJudgeLLM routed through Helicone."""
        return self.base_url.rstrip("/") + "/v1/"


helicone_config = HeliconeSingleton()
