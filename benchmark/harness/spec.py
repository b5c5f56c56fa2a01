"""Finding a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
each per-layer metric. The harness reads a configuration from the file
the configuration's entry names, a traffic mix from
``traffic/<name>.json`` and a per-layer metric's reader from
``metrics/<name>.py``, all beside this package: a later change adds a
configuration, a mix or a metric by adding files and entries, and edits
none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json``, its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not UNIT_RE.match(unit):
        raise ValueError(f"not a valid unit: {unit!r}")
    return unit


def load_reader(path: Path) -> Callable:
    """The ``read`` function of a metric file."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric belongs to the cells it lists, or else to every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files found by
    name under ``bench_dir`` (default: ``root/benchmark``)."""
    bench_dir = bench_dir or root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[check_name(w["config"])]["file"])
                        .read_text())
    mesh = config.get("mesh")
    slots = mesh["dp"] * mesh["corpus"] if mesh else 1
    if slots != int(w["chips"]):
        raise ValueError(f"{name}: {w['chips']} chips, but its "
                         f"configuration lays out {slots} slot(s)")
    traffic = json.loads((bench_dir / "traffic"
                          / f"{check_name(w['traffic'])}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, e2e_names)]
    for m in e2e + layer:
        check_name(m["name"])
        check_unit(m["unit"])
    readers = {m["name"]: load_reader(bench_dir / "metrics"
                                      / f"{m['name']}.py") for m in layer}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer,
                readers=readers)
