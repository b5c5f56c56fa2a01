"""A configuration names the system that serves it; the harness finds
the system's driver by name, counts a mesh's slots over all its axes,
takes only the axes the system lays out, and gives a cell no per-layer
metric that reads what its system's window does not feed."""

import dataclasses
import json
import shutil

import pytest

from benchmark.harness import runner, spec, trace
from benchmark.harness.spec import BENCH_DIR, ROOT, load_cell
from benchmark.tests.fixtures import stage

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
GENERATION_CELL = "qwen3-1.7b.rag-answer"


@pytest.mark.parametrize("cell", CELLS)
def test_config_without_system_runs_the_retrieval_runner(cell):
    c = load_cell(cell)
    assert "system" not in c.config and c.system == spec.RETRIEVAL
    assert c.driver is runner and c.driver.run is runner.run


@pytest.mark.parametrize("cell,metrics", [
    ("nq-q256-bf16.frames", {"sched.rows_per_batch", "retriever.device_ms",
                             "k1.roofline_pct", "device.idle_pct"}),
    ("msmarco-q1024-int8.frames", {"sched.rows_per_batch",
                                   "retriever.device_ms", "k2.roofline_pct",
                                   "device.idle_pct"}),
    ("msmarco2-q1024-int8-4chip.frames", {
        "sched.rows_per_batch", "retriever.device_ms", "k2.roofline_pct",
        "device.idle_pct", "cards.all_busy_pct"}),
])
def test_each_retrieval_cell_keeps_its_per_layer_metrics(cell, metrics):
    c = load_cell(cell)
    assert {m["name"] for m in c.per_layer} == set(c.readers) == metrics


def _root_with(tmp_path, config_edit, chips=1):
    """A copy of the benchmark whose one new cell's configuration is the
    first cell's, edited by ``config_edit``."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / doc["configs"][0]["file"]).read_text())
    cfg.pop("mesh", None)
    config_edit(cfg)
    (tmp_path / "benchmark" / "configs" / "edited.json").write_text(
        json.dumps(cfg))
    doc["configs"].append({"name": "edited", "source": "x",
                           "file": "benchmark/configs/edited.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "edited.frames", "config": "edited",
                             "traffic": "frames", "chips": chips,
                             "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp_path


def _echo_system(root, axes=()):
    """A system ``echo`` whose run returns its cell's system; it lays out
    ``axes`` and feeds the device trace."""
    (root / "benchmark" / "systems" / "echo.py").write_text(
        f"FEEDS = ('device',)\nMESH_AXES = {tuple(axes)!r}\n\n\n"
        "def run(cell, *args, **kw):\n    return {'system': cell.system}\n")


@pytest.mark.parametrize("system", ["nosuch", "a/b", ""])
def test_unknown_system_raises(tmp_path, system):
    root = _root_with(tmp_path, lambda c: c.update(system=system))
    with pytest.raises(ValueError):
        load_cell("edited.frames", root=root)


def test_a_system_is_found_by_name(tmp_path):
    root = _root_with(tmp_path, lambda c: c.update(system="echo"))
    _echo_system(root)
    cell = load_cell("edited.frames", root=root)
    assert cell.system == "echo" and cell.bench_dir == root / "benchmark"
    assert cell.driver.run(cell, 1, 1.0, False, 0.0) == {
        "system": "echo"}
    # The metrics that read only the device trace, as the system feeds.
    assert set(cell.readers) == {"device.idle_pct"}


@pytest.mark.parametrize("mesh,chips,ok", [
    ({"dp": 1, "tp": 4, "corpus": 1}, 4, True),
    ({"dp": 1, "tp": 2, "corpus": 2}, 4, True),
    ({"dp": 2, "tp": 2, "corpus": 2}, 4, False),
    ({"dp": 1, "tp": 2, "corpus": 1}, 4, False),
    ({"dp": 2, "tp": 1, "corpus": 2}, 1, False),
])
def test_slot_count_is_the_mesh_product(tmp_path, mesh, chips, ok):
    root = _root_with(tmp_path, lambda c: c.update(mesh=mesh, system="echo"),
                      chips=chips)
    _echo_system(root, axes=("dp", "tp", "corpus"))
    if ok:
        assert load_cell("edited.frames", root=root).chips == chips
    else:
        with pytest.raises(ValueError, match="slot"):
            load_cell("edited.frames", root=root)


@pytest.mark.parametrize("mesh", [{"tp": 4}, {"dp": 4},
                                  {"dp": 1, "tp": 2, "corpus": 2}])
def test_retrieval_takes_only_dp_and_corpus(tmp_path, mesh):
    root = _root_with(tmp_path, lambda c: c.update(mesh=mesh), chips=4)
    with pytest.raises(ValueError, match="mesh over"):
        load_cell("edited.frames", root=root)


@pytest.fixture
def staged(tmp_path):
    """A copy of the benchmark with the generation fixture's cell."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copyfile(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    stage.add_fixture(tmp_path)
    return tmp_path


def _edit(root, path, edit):
    doc = json.loads((root / path).read_text())
    edit(doc)
    (root / path).write_text(json.dumps(doc))


@pytest.mark.parametrize("mesh", [{"dp": 1, "corpus": 1}, {"tp": 1}])
def test_generation_takes_no_mesh(staged, mesh):
    _edit(staged, "benchmark/configs/qwen3-1.7b.json",
          lambda c: c.update(mesh=mesh))
    with pytest.raises(ValueError, match="mesh over"):
        load_cell(GENERATION_CELL, root=staged)


def test_generation_runs_on_one_card_only(staged):
    cell = dataclasses.replace(load_cell(GENERATION_CELL, root=staged),
                               chips=4)
    with pytest.raises(ValueError, match="one card"):
        cell.driver.run(cell, 1, 1.0, False, 0.0, rehearse=True)


def test_the_generation_cell_gets_what_its_window_feeds(staged):
    cell = load_cell(GENERATION_CELL, root=staged)
    assert cell.system == "generation"
    assert cell.driver.FEEDS == ("device", "server")
    assert [m["name"] for m in cell.per_layer] == ["device.idle_pct"]
    assert set(cell.readers) == {"device.idle_pct"}


@pytest.mark.parametrize("listed", [False, True])
def test_a_metric_the_system_does_not_feed_is_refused(staged, listed):
    """A per-layer metric that reads the scheduler's batches and moves
    ``qps`` belongs, without a ``workloads`` key, to the generation cell
    too, whose window has no batches: the cell is refused. Listed for the
    retrieval cells only, it stays out of the generation cell."""
    (staged / "benchmark" / "metrics" / "batch.count.py").write_text(
        "READS = ('batches',)\n\n\ndef read(w):\n"
        "    return w.stats.get('batches_run')\n")
    entry = {"name": "batch.count", "unit": "batches", "better": "higher",
             "source": "program_counter", "layer": "scheduler",
             "moves": "qps"}
    if listed:
        entry["workloads"] = CELLS
    _edit(staged, "BENCHMARK.json", lambda d: d["per_layer"].append(entry))
    if listed:
        cell = load_cell(GENERATION_CELL, root=staged)
        assert "batch.count" not in cell.readers
        assert "batch.count" in load_cell(CELLS[0], root=staged).readers
    else:
        with pytest.raises(ValueError, match="workloads"):
            load_cell(GENERATION_CELL, root=staged)


def test_a_metric_file_states_what_it_reads(staged):
    (staged / "benchmark" / "metrics" / "device.idle_pct.py").write_text(
        "def read(w):\n    return 1.0\n")
    with pytest.raises(ValueError, match="READS"):
        load_cell(GENERATION_CELL, root=staged)


def _generation_window(ops):
    """A traced window as the generation driver makes it: the server's
    counters, no batches."""
    spans = {0: trace._union(ops)}
    return trace.Window(
        device_ops=ops, busy_s=trace.mean_busy_s(spans), window_s=2.0,
        batch_rows=[], stats={"ticks": 12, "tokens_emitted": 768,
                              "prefix_cache_hits": 16,
                              "prompt_tokens": 48000},
        config={"lm": {}}, chips=1, card_spans=spans,
        card_busy_s={0: trace.spans_s(spans[0])})


def test_retrieval_readers_read_none_on_a_generation_window():
    ops = [("sm90_xmma_gemm_bf16bf16", 0.0, 5e5),
           ("elementwise_kernel", 6e5, 4e5)]
    w = _generation_window(ops)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    readers = {m["name"]: spec.load_reader(BENCH_DIR / "metrics"
                                           / f"{m['name']}.py")
               for m in doc["per_layer"]}
    got = trace.read_metrics(readers, w)
    assert set(got) == {"device.idle_pct"}
    assert got["device.idle_pct"] == pytest.approx(55.0)
