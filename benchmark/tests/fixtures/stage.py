"""Stage a checkout in which a fixture's cells are cells of the benchmark.

    python3 benchmark/tests/fixtures/stage.py <dest> [--fixture generation]

Copies ``BENCHMARK.json``, ``benchmark/`` and the port's package from the
root of this checkout to ``<dest>``, then adds the fixture's files
(``fixtures/<fixture>/<dir>/...`` to ``<dest>/benchmark/<dir>/...``) and
appends the entries of its ``BENCHMARK.entries.json`` to
``<dest>/BENCHMARK.json``: new files and entries only, as a later change
adds a cell. A fixture file that would replace one the benchmark has is
refused. Then, from ``<dest>``, ``python3 benchmark/run.py --workload
<fixture's cell> ...`` runs it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
PORT = "a_nice_rag_tpu_torch"
ENTRIES = "BENCHMARK.entries.json"
SKIP = shutil.ignore_patterns("__pycache__", "_build", ".bench_cache")


def add_fixture(dest: Path, fixture: str = "generation") -> list:
    """The fixture's files and entries added to the checkout at ``dest``;
    returns the files added (relative to ``dest``)."""
    src = HERE / fixture
    added = []
    for path in sorted(p for p in src.rglob("*") if p.is_file()
                       and p.name != ENTRIES):
        rel = Path("benchmark") / path.relative_to(src)
        if (dest / rel).exists():
            raise FileExistsError(f"{rel} is already in the benchmark")
        (dest / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(path, dest / rel)
        added.append(rel)
    doc = json.loads((dest / "BENCHMARK.json").read_text())
    for group, entries in json.loads((src / ENTRIES).read_text()).items():
        names = {e["name"] for e in doc[group]}
        for e in entries:
            if e["name"] in names:
                raise ValueError(f"{group} already has {e['name']!r}")
            doc[group].append(e)
    (dest / "BENCHMARK.json").write_text(json.dumps(doc, indent=1) + "\n")
    return added


def stage(dest: Path, fixture: str = "generation") -> list:
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("benchmark", PORT):
        shutil.copytree(ROOT / sub, dest / sub, ignore=SKIP)
    return add_fixture(dest, fixture)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dest", type=Path)
    p.add_argument("--fixture", default="generation")
    args = p.parse_args(argv)
    if args.dest.exists():
        shutil.rmtree(args.dest)
    for rel in stage(args.dest, args.fixture):
        print(rel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
