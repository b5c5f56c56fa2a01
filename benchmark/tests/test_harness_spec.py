"""Names, units and finding a cell's files by name."""

import json
import shutil

import pytest

from benchmark.harness import spec
from benchmark.harness.spec import BENCH_DIR, ROOT, load_cell


def test_benchmark_json_names_and_units():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in doc[group]:
            spec.check_name(entry["name"])
            if "unit" in entry:
                spec.check_unit(entry["unit"])
    for w in doc["workloads"]:
        spec.check_name(w["config"])
        spec.check_name(w["traffic"])
        load_cell(w["name"])


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", ".a", "", "µs",
                                 "x" * 65])
def test_bad_names_refused(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True),
                                     ("queries/s", True), ("ms", True),
                                     ("tokens per s", False), ("µs", False),
                                     ("x" * 17, False)])
def test_units(unit, ok):
    if ok:
        spec.check_unit(unit)
    else:
        with pytest.raises(ValueError):
            spec.check_unit(unit)


def test_new_files_found_by_name_without_edits(tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a new
    file with a new BENCHMARK.json entry, are found by name."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "nq-q256-bf16.json").read_text())
    cfg["name"] = "newcfg"
    (bench / "configs" / "newcfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "closed", "clients": 3, "rows_per_request": 7,
         "pool_rows": 70, "check_rows": 14}))
    (bench / "metrics" / "new.metric.py").write_text(
        "READS = ('device',)\n\n\ndef read(w):\n    return 42.0\n")
    doc["configs"].append({"name": "newcfg", "source": "x",
                           "file": "benchmark/configs/newcfg.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "newcfg.burst", "config": "newcfg",
                             "traffic": "burst", "chips": 1, "why": "x"})
    doc["per_layer"].append({"name": "new.metric", "unit": "x",
                             "better": "higher", "source": "program_counter",
                             "layer": "x", "moves": "qps",
                             "workloads": ["newcfg.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    doc["workloads"].append({"name": "newcfg.chat", "config": "newcfg",
                             "traffic": "chat", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    assert load_cell("newcfg.chat", root=tmp_path).traffic["clients"] == 64
    cell = load_cell("newcfg.burst", root=tmp_path)
    assert cell.config["name"] == "newcfg"
    assert cell.traffic["rows_per_request"] == 7
    assert cell.readers["new.metric"](None) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {
        "qps", "p50_ms", "p95_ms", "setup_s"}
    # Metrics listed for other cells stay out; unlisted ones come in by
    # the end-to-end metric they move.
    assert "k1.roofline_pct" not in cell.readers
    assert "sched.rows_per_batch" not in cell.readers
    assert "device.idle_pct" in cell.readers


@pytest.mark.parametrize("chips", [1, 2])
def test_chips_must_match_the_mesh(tmp_path, chips):
    """A cell's chips and its configuration's mesh (dp x corpus, one slot
    without a mesh) state one number: where they differ, it is refused."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in doc["workloads"]:
        slots = load_cell(w["name"]).config.get("mesh", {"dp": 1,
                                                          "corpus": 1})
        if slots["dp"] * slots["corpus"] != chips:
            w["chips"] = chips
            (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
            with pytest.raises(ValueError, match="slot"):
                load_cell(w["name"], root=tmp_path)


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in doc["workloads"]:
        cell = load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
