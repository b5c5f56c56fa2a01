"""Evaluation runtime configuration and retry policy.

Same knob surface as the reference (ragas_modified/run_config.py:51-60):
timeout 180s per metric call, up to 10 retries with exponential jitter
capped at 60s, 16 concurrent workers, seed 42.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random

@dataclasses.dataclass
class RunConfig:
    timeout: int = 180
    max_retries: int = 10
    max_wait: int = 60
    max_workers: int = 16
    exception_types: tuple = (Exception,)
    log_tenacity: bool = False
    seed: int = 42

    def __post_init__(self) -> None:
        self.rng = random.Random(self.seed)


async def with_retries(fn, run_config: RunConfig, *args, **kwargs):
    """Exponential-jitter async retry wrapper (tenacity-equivalent)."""
    attempt = 0
    while True:
        try:
            return await fn(*args, **kwargs)
        except run_config.exception_types:
            attempt += 1
            if attempt >= run_config.max_retries:
                raise
            backoff = min(
                run_config.max_wait, (2 ** attempt) * run_config.rng.random()
            )
            await asyncio.sleep(backoff)
