"""Finding a cell's files by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
each per-layer metric. The harness reads a configuration from the file
the configuration's entry names, a traffic mix from
``traffic/<name>.json`` and a per-layer metric's reader from
``metrics/<name>.py``, all beside this package. A configuration names
the system that serves it with ``"system": "<name>"``: without the key
it is ``retrieval``, run by ``harness/runner.py``; any other name is run
by ``systems/<name>.py``, found by name as the rest. A later change adds
a configuration, a mix, a metric or a system by adding files and
entries, and edits none.

A system's driver states the axes a configuration's ``mesh`` may have
(``MESH_AXES``) and what its traced window feeds the readers
(``FEEDS``); a metric's reader states what it reads (``READS``). A cell
is refused where its mesh has other axes, or where a per-layer metric
that belongs to it reads what its system does not feed: such a metric
would read nothing there, and a metric with no ``workloads`` key has to
be reported in every cell that reports the end-to-end metric it moves.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

RETRIEVAL = "retrieval"

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
    # The system that serves the cell (``retrieval`` or a file of
    # ``systems/``), its driver module (``driver``: ``driver.run`` runs
    # one run), and the benchmark's directory its files were found in.
    system: str
    driver: ModuleType
    bench_dir: Path


def check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not UNIT_RE.match(unit):
        raise ValueError(f"not a valid unit: {unit!r}")
    return unit


def load_module(path: Path, prefix: str):
    """The module of a file found by name (a metric's reader, a system's
    driver, a model's arch file)."""
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    # Registered first: a dataclass looks its module up while it is made.
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_metric(path: Path) -> ModuleType:
    """A metric file's module: ``read(window)`` and ``READS``, the feeds
    of ``trace.Window`` it reads."""
    module = load_module(path, "benchmark_metric_")
    if not isinstance(getattr(module, "READS", None), tuple):
        raise ValueError(f"{path} states no READS tuple")
    return module


def load_reader(path: Path) -> Callable:
    """The ``read`` function of a metric file."""
    return load_metric(path).read


def driver(bench_dir: Path, system: str) -> ModuleType:
    """The driver module of ``system``: ``harness/runner.py`` for
    retrieval, else ``systems/<system>.py``. Each has ``run`` (cell, seed,
    seconds, traced, t_process, rehearse=False, control=False,
    marks=None), which returns the result line's object, and
    ``MESH_AXES`` and ``FEEDS``."""
    if system == RETRIEVAL:
        from benchmark.harness import runner

        return runner
    path = bench_dir / "systems" / f"{check_name(system)}.py"
    if not path.is_file():
        raise ValueError(f"no system {system!r}: {path} does not exist")
    return load_module(path, "benchmark_system_")


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
    system = check_name(config.get("system", RETRIEVAL))
    module = driver(bench_dir, system)
    mesh = config.get("mesh")
    if mesh is not None and set(mesh) != set(module.MESH_AXES):
        raise ValueError(f"{name}: the {system} system lays out a mesh "
                         f"over {list(module.MESH_AXES)}, not {list(mesh)}")
    slots = math.prod(int(v) for v in mesh.values()) if mesh else 1
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
    readers = {}
    for m in layer:
        metric = load_metric(bench_dir / "metrics" / f"{m['name']}.py")
        unfed = sorted(set(metric.READS) - set(module.FEEDS))
        if unfed:
            raise ValueError(
                f"{name}: per-layer metric {m['name']!r} reads {unfed}, "
                f"which the {system} system's window does not feed; list "
                f"the cells that feed it under the metric's \"workloads\"")
        readers[m["name"]] = metric.read
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer,
                readers=readers, system=system, bench_dir=bench_dir,
                driver=module)
