"""The readings that set the limits of ``correct``: the program's numbers
and the control's on the same sampled rows, seed after seed, in one
process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 5 [--control-seeds N]

Each seed is a whole run (``run.py``'s set-up, a window of ``--seconds``
at the cell's own load, the check); the control is the reference put in
the program's place one precision lower (``harness/reference.py``; for a
model, its arch file's ``reference_logprobs``), on the rows or replies
the run sampled, and judged by the cell's limits as the program is
(``control_correct``, false where the control fails). One JSON line a
seed, with every number the program read, also those that have no limit
yet. The benchmark's own runs never run the control.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", type=int, default=1 << 30,
                   help="compute the control on the first N seeds only")
    args = p.parse_args()

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    run = cell.driver.run
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = run(cell, seed, args.seconds, False, time.perf_counter(),
                  control=i < args.control_seeds)
        info = out["info"]
        line = {"seed": seed, "correct": out["correct"],
                "program": info.get("program") or {
                    k: c["value"] for k, c in out["checks"].items()},
                "control": info.get("control"),
                "control_correct": info.get("control_correct"),
                "attempted": out["attempted"],
                "setup_marks": info["setup_marks"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
