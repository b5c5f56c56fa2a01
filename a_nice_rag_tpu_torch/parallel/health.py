"""Slot health monitoring and automatic shard recovery.

Counterpart of ``a_nice_rag_tpu/parallel/health.py``. A monitor probes
every slot of the serving pool with a tiny computation whose value is
read back; when an active slot stops answering it lays the corpus out
again over the healthy slots (``parallel.sharded.reshard_surviving``)
and hands the new ShardedIndex to a rebuild callback, so the caller can
recreate its retrievers. Pool slots outside the active mesh are warm
spares: they join on the next recovery. ``probe_fn`` injects faults in
tests.

Health is kept per slot, not per device: slots of a virtual mesh share
one device, and a dict keyed by device would merge them.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


def default_probe(slot, timeout_s: float) -> bool:
    """True iff the slot's device (or a device given as such) returns a
    tiny computation's value within ``timeout_s``.

    The value is read (``.item()``), not merely waited on, so a wedged
    device cannot report healthy; any exception counts as unhealthy. A
    probe that times out is left to finish in its worker thread.
    """
    device = getattr(slot, "device", slot)

    def attempt():
        x = torch.arange(8, dtype=torch.float32, device=device)
        return (x * 2.0).sum().item()

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(attempt).result(timeout=timeout_s) == 56.0
    except Exception:  # noqa: BLE001 — any failure means unhealthy
        return False
    finally:
        pool.shutdown(wait=False)


class DeviceHealthMonitor:
    """Probe the slot pool; reshard the corpus over survivors on failure.

    Args:
        sidx: the live ShardedIndex being served.
        rebuild: callback receiving the recovered ShardedIndex; recreate
            retrievers there. Called on the monitor thread.
        pool: candidate slots (default: the active mesh's). Slots beyond
            the active mesh are warm spares.
        dp: data-parallel axis size kept on recovery.
        probe_timeout_s / probe_interval_s: failure detector settings.
        probe_fn: (slot, timeout_s) -> bool; injectable for tests.
    """

    def __init__(
        self,
        sidx,
        rebuild: Callable[[object], None],
        pool: Optional[Sequence] = None,
        dp: int = 1,
        probe_timeout_s: float = 10.0,
        probe_interval_s: float = 30.0,
        probe_fn: Callable = default_probe,
    ):
        self.sidx = sidx
        self.rebuild = rebuild
        self.pool: List = list(pool if pool is not None else sidx.mesh.slots)
        self.dp = dp
        self.probe_timeout_s = probe_timeout_s
        self.probe_interval_s = probe_interval_s
        self.probe_fn = probe_fn
        self.events: List[Dict] = []  # probes and recoveries, in order
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def probe(self) -> Dict:
        """One health check of the pool: slot -> healthy."""
        return {s: self.probe_fn(s, self.probe_timeout_s) for s in self.pool}

    def active_devices(self) -> List:
        """The slots of the active mesh."""
        return list(self.sidx.mesh.slots)

    def check_and_recover(self) -> bool:
        """Probe; if an ACTIVE slot died, reshard over the healthy pool
        slots (spares included). Returns True when a recovery ran."""
        health = self.probe()
        dead_active = [s for s in self.active_devices()
                       if not health.get(s, False)]
        self.events.append({"ts": time.time(),
                            "healthy": sum(health.values()),
                            "dead_active": len(dead_active)})
        if not dead_active:
            return False
        survivors = [s for s in self.pool if health[s]]
        usable = (len(survivors) // self.dp) * self.dp
        if usable < self.dp:
            logger.error("health: %d dead, only %d survivors — cannot "
                         "reshard", len(dead_active), len(survivors))
            self.events[-1]["recovered"] = False
            return False
        from a_nice_rag_tpu_torch.parallel.sharded import reshard_surviving

        logger.warning("health: %d active slot(s) dead; resharding over %d "
                       "survivors", len(dead_active), usable)
        self.sidx = reshard_surviving(self.sidx, survivors[:usable],
                                      dp=self.dp)
        self.rebuild(self.sidx)
        self.events[-1]["recovered"] = True
        self.events[-1]["n_shards"] = self.sidx.n_shards
        return True

    def start(self) -> None:
        """Run check_and_recover on a background thread every interval."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.probe_interval_s):
                try:
                    self.check_and_recover()
                except RuntimeError as e:
                    if "interpreter shutdown" in str(e):
                        return  # process exiting; wind the daemon down
                    logger.exception("health: probe cycle failed")
                except Exception:  # noqa: BLE001 — keep the monitor alive
                    logger.exception("health: probe cycle failed")

        self._thread = threading.Thread(target=loop, name="device-health",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
