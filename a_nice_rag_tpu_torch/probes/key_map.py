"""T1's time, the key map (``xpack_keys`` / ``xpack_values``), for the port
in any checkout.

    python -m a_nice_rag_tpu_torch.probes.key_map [--root DIR] [--plans]
        [--out FILE]

Imports ``a_nice_rag_tpu_torch`` from ``--root`` (default: the checkout
holding this file), so one call can time two trees on one card in turns
(parent, change, change, parent), each its own process. The cases
(``inputs``): the 13 special values of the JAX package's key test and
2^24 normals (10 x randn, seed 151: ``chip_smoke.py`` phase 15's input),
2^24 normals (every word in whole vectors), the first case from its
second word on (a view 4 bytes past the 16-byte grid) and 2^26 + 3
normals (537 MB read and written, far past the 50 MB L2). For each case
and each map (``measure``): the event pair around one call (median of
10 after 3 warm-ups), 50 calls between one pair of events (best of 3),
the kernels of one call alone and their count (``torch.profiler``, 50
calls), the host's ms a call (50 calls, no synchronize), beside
``x.clone()`` of the same input (the same bytes through CUDA's own
device-to-device copy: a copy yardstick, not a library call computing
the map),
the HBM bound (8 bytes an element over 3.35 TB/s), whether both maps
and the round trip equal the plain versions, and the outputs' SHA-256,
so two trees' outputs can be held equal. ``--plans`` (trees with
``keys.key_plan``) adds the kernel alone under each of 4 or 8 loads in
flight and 4 or 8 CTAs on each SM. One JSON line, card first, also
appended to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
HBM_BYTES_S = 3.35e12
SEED = 151
NORMALS = 1 << 24
LARGE = (1 << 26) + 3
N_LOOP = 50
SPECIAL = (-float("inf"), -3.3e38, -1.0, -2e-38, -1e-45, -0.0, 0.0, 1e-45,
           2e-38, 0.5, 1.0, 3.3e38, float("inf"))
PLAN_CTAS = (4, 8)


def inputs(device, g, normals: int = NORMALS, large: int = LARGE) -> dict:
    """The cases by name (specials_and_normals, normals, offset_1, large):
    float32 tensors on ``device`` drawn from generator ``g``; the first is
    phase 15's input, and offset_1 a view of it from its second word."""
    import torch

    x = torch.cat([torch.tensor(SPECIAL, dtype=torch.float32, device=device),
                   10 * torch.randn(normals, generator=g, device=device)])
    return {"specials_and_normals": x, "normals": x[:normals].clone(),
            "offset_1": x[1:],
            "large": 10 * torch.randn(large, generator=g, device=device)}


def time_call(fn, t, n_loop: int = N_LOOP) -> dict:
    """One function's times through the timers ``t`` (``cuda_event_ms``,
    ``device_loop_ms``, ``profiled_call``: the device ms and the kernels of
    one call, from one trace)."""
    import torch

    out = {"event_ms": t.cuda_event_ms(fn),
           "device_ms": t.device_loop_ms(fn, n_loop=n_loop, trials=3)}
    out["kernel_ms"], out["launches"] = t.profiled_call(fn, n_loop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_loop):
        fn()
    out["host_ms"] = (time.perf_counter() - t0) / n_loop * 1e3
    torch.cuda.synchronize()
    return out


def _sha256(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def measure(cases: dict, k, t, n_loop: int = N_LOOP) -> list:
    """Each case's line: both maps of the kernels module ``k`` and
    ``x.clone()`` timed through ``t`` (``time_call``), the bound, the
    check against the plain versions and the outputs' SHA-256."""
    import torch

    lines = []
    for name, x in cases.items():
        keys = k.xpack_keys(x)
        back = k.xpack_values(keys)
        torch.cuda.synchronize()
        equal = (torch.equal(keys, k.xpack_keys_torch(x))
                 and torch.equal(back.view(torch.int32),
                                 x.view(torch.int32))
                 and torch.equal(k.xpack_values_torch(keys).view(
                     torch.int32), x.view(torch.int32)))
        n = x.numel()
        lines.append({
            "case": name, "n": n, "offset_words": x.data_ptr() % 16 // 4,
            "bound_ms": 8 * n / HBM_BYTES_S * 1e3, "equal_plain": equal,
            "xpack_keys": time_call(lambda: k.xpack_keys(x), t, n_loop),
            "xpack_values": time_call(lambda: k.xpack_values(keys), t,
                                      n_loop),
            "clone": time_call(x.clone, t, n_loop),
            "sha256": {"keys": _sha256(keys), "values": _sha256(back)},
        })
        del keys, back
    return lines


def sweep_plans(cases: dict, keys_module, t, n_loop: int = N_LOOP) -> list:
    """The key map's kernel alone under each (loads in flight, CTAs on
    each SM) of ``keys_module.key_plan``, at every case."""
    import torch

    lines = []
    sms = keys_module._sms(next(iter(cases.values())).device)
    for unroll, ctas in itertools.product(keys_module.KEY_UNROLLS,
                                          PLAN_CTAS):
        for name, x in cases.items():
            plan = keys_module.key_plan(x.numel(), x.data_ptr() % 16 // 4,
                                        sms, unroll, ctas)

            def fn(x=x, plan=plan):
                return keys_module._flip(keys_module.xpack_keys,
                                         "anr_xpack_keys", x, torch.int32,
                                         plan)

            kernel_ms, launches = t.profiled_call(fn, n_loop)
            lines.append({"unroll": unroll, "ctas_per_sm": ctas,
                          "case": name, "grid": plan.grid,
                          "kernel_ms": kernel_ms, "launches": launches,
                          "device_ms": t.device_loop_ms(fn, n_loop=n_loop,
                                                       trials=3)})
    return lines


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    root = str(Path(args.root).resolve())
    if root != str(REPO):
        # Run as a module, this file's own package is already imported:
        # drop it, so that the tree under --root is the one timed.
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "a_nice_rag_tpu_torch"]:
            del sys.modules[name]
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA GPU visible", file=sys.stderr)
        return 3
    from a_nice_rag_tpu_torch import bench
    from a_nice_rag_tpu_torch.ops import kernels
    from a_nice_rag_tpu_torch.ops.kernels import keys as keys_module
    from a_nice_rag_tpu_torch.testing import timing

    dev = torch.device("cuda")
    t = types.SimpleNamespace(
        cuda_event_ms=timing.cuda_event_ms,
        device_loop_ms=timing.device_loop_ms,
        profiled_call=lambda fn, n: timing.profiled_device_ms(fn, n,
                                                              warmup=3))
    cases = inputs(dev, torch.Generator(device=dev).manual_seed(SEED))
    out = {"card": bench.card_line(), "root": root,
           "method": "event_ms: CUDA events around one call, median of 10 "
           "after 3 warm-ups; device_ms: 50 calls between one pair of "
           "events, best of 3; kernel_ms / launches: torch.profiler, the "
           "device time and kernels of one call over 50 calls; host_ms: "
           "host clock over 50 calls without a synchronize",
           "cases": measure(cases, kernels, t)}
    if args.plans:
        out["plans"] = sweep_plans(cases, keys_module, t)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
