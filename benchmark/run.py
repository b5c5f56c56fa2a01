"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is one JSON object: correct,
attempted, failed, metrics (end-to-end with --trace 0, per-layer with
--trace 1), device, with --trace 1 breakdown, and last the numbers
compared with their limits (also the last lines of standard error).
Exits 2 without printing a result where there is no CUDA device or too
few, and 3 where JAX or the JAX package was loaded.

``--rehearse`` runs the cell's whole control flow at the configuration's
rehearsal size on the CPU, with the port's plain versions, and prints no
metric and no device.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# Caches of anything built at run time stay in the checkout, at a fixed
# path; no library may load JAX for the port.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def _plain(x):
    """JSON has no infinity: a check that reads +inf prints 1e300."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300 if x > 0 else -1e300
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)

    import torch

    t_torch = time.perf_counter() - T_PROCESS
    from benchmark.harness import runner
    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not args.rehearse:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {have}", file=sys.stderr)
            return 2
    result = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace),
                             T_PROCESS, rehearse=args.rehearse,
                             marks={"torch": t_torch})
    bad = runner.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    result = _plain(result)
    print(json.dumps(result))
    sys.stdout.flush()
    print(runner.checks_text(result), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
