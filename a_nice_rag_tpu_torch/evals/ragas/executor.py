"""Bounded async job executor.

Reference semantics (ragas_modified/executor.py): submit (index, coroutine)
jobs, run them under a max_workers semaphore, convert per-job exceptions
to NaN unless raise_exceptions, and return results re-sorted by submit
order. Progress is reported through tqdm when available.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Any, Callable, Coroutine, List, Optional, Tuple

import numpy as np

from a_nice_rag_tpu_torch.evals.ragas.run_config import RunConfig

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Executor:
    desc: str = "Evaluating"
    raise_exceptions: bool = False
    run_config: Optional[RunConfig] = None
    show_progress: bool = True
    batch_size: Optional[int] = None

    def __post_init__(self):
        self.jobs: List[Tuple[int, Callable[[], Coroutine]]] = []

    def submit(self, fn: Callable[..., Coroutine], *args, **kwargs) -> None:
        index = len(self.jobs)
        self.jobs.append((index, lambda: fn(*args, **kwargs)))

    async def _run_one(self, semaphore, index, thunk, progress):
        async with semaphore:
            try:
                result = await thunk()
            except Exception as e:  # noqa: BLE001 — NaN isolation contract
                if self.raise_exceptions:
                    raise
                logger.error("Job %d failed: %s", index, e)
                result = np.nan
            if progress is not None:
                progress.update(1)
            return index, result

    async def _run_all(self) -> List[Any]:
        rc = self.run_config or RunConfig()
        semaphore = asyncio.Semaphore(rc.max_workers)
        progress = None
        if self.show_progress:
            try:
                from tqdm.auto import tqdm

                progress = tqdm(total=len(self.jobs), desc=self.desc)
            except ImportError:
                pass
        jobs = self.jobs
        results: List[Tuple[int, Any]] = []
        batches = (
            [jobs[i : i + self.batch_size]
             for i in range(0, len(jobs), self.batch_size)]
            if self.batch_size
            else [jobs]
        )
        try:
            for batch in batches:
                done = await asyncio.gather(
                    *(
                        self._run_one(semaphore, i, thunk, progress)
                        for i, thunk in batch
                    )
                )
                results.extend(done)
        finally:
            if progress is not None:
                progress.close()
        results.sort(key=lambda pair: pair[0])
        return [r for _, r in results]

    def results(self) -> List[Any]:
        """Run all submitted jobs to completion (sync entrypoint)."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return asyncio.run(self._run_all())
        raise RuntimeError(
            "Executor.results() inside a running event loop; "
            "use `await executor.aresults()`"
        )

    async def aresults(self) -> List[Any]:
        return await self._run_all()
