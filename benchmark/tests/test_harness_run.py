"""A whole run of each cell at its rehearsal size on the CPU, and the
same run with the timed path broken underneath: ``correct`` comes out
false for each fault a cell can have."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import runner
from benchmark.harness.spec import ROOT, load_cell
from a_nice_rag_tpu_torch.parallel import sharded
from a_nice_rag_tpu_torch.retrieval.engine import FusedRetriever

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 977


def _rehearse(cell_name, seed=SEED):
    return runner.run(load_cell(cell_name), seed, 1.0, False,
                      time.perf_counter(), rehearse=True)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(cell):
    out = _rehearse(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # A CPU run prints no metric and no device.
    assert "metrics" not in out and "device" not in out
    assert list(out)[-1] == "checks"
    # Set-up's steps, in order, ending where set-up ends.
    marks = list(out["info"]["setup_marks"].values())
    assert marks == sorted(marks) and list(out["info"]["setup_marks"]) == [
        "imports", "data", "index", "served", "warm"]


def _sharded(cell):
    return "mesh" in load_cell(cell).config


def _broken(monkeypatch, cell, alter):
    """``alter`` the outputs of the cell's retriever where they are
    produced: a FusedRetriever's retrieve_device, a ShardedRetriever's
    retrieve_lists (which its retrieve_device returns the first two of)."""
    cls, name = ((sharded.ShardedRetriever, "retrieve_lists")
                 if _sharded(cell) else (FusedRetriever, "retrieve_device"))
    real = getattr(cls, name)

    def broken(self, *a, **kw):
        return alter(*real(self, *a, **kw))

    monkeypatch.setattr(cls, name, broken)


def _half_left_out(fids, fvals, lists):
    """Half of the batch not computed: its rows get the first half's."""
    h = fids.shape[0] // 2
    if h == 0:
        return fids, fvals, lists
    fids, fvals, lists = fids.clone(), fvals.clone(), lists.clone()
    fids[h:2 * h] = fids[:h]
    fvals[h:2 * h] = fvals[:h]
    lists[:, h:2 * h] = lists[:, :h]
    return fids, fvals, lists


def _answer_altered(fids, fvals, lists):
    """One id of every list changed where it is produced, and the fused
    reply with it."""
    lists = lists.clone()
    lists[:, :, 3] = (lists[:, :, 3] + 1) % 97
    fids = fids.clone()
    fids[:, 3] = (fids[:, 3] + 1) % 97
    return fids, fvals, lists


def _fused_altered(fids, fvals, lists):
    """The lists right, the fused reply's scores altered."""
    return fids, fvals + 1e-3, lists


# A one-list cell replies with its list's ids and scores 0: altering the
# fused scores alone is a fault of the fused cells only.
FAULTS = [(c, f) for c in CELLS for f in (_half_left_out, _answer_altered,
                                          _fused_altered)
          if f is not _fused_altered or "bm25" in load_cell(c).config]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_makes_it_incorrect(monkeypatch, cell, fault):
    _broken(monkeypatch, cell, fault)
    out = _rehearse(cell)
    assert not out["correct"], out["checks"]


SHARDED = [c for c in CELLS if _sharded(c)]


@pytest.mark.parametrize("cell", SHARDED)
def test_exchange_left_out_is_caught(monkeypatch, cell):
    """The exchange between the cards left out: the lead card merges its
    own shard's list alone."""
    real = sharded._merge_over

    def lead_only(sidx, vals, gidx, k, lead):
        return real(sidx, vals[:1], gidx[:1], k, lead)

    monkeypatch.setattr(sharded, "_merge_over", lead_only)
    out = _rehearse(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["dense_gap"]["value"] > 0


def _routing_fault(monkeypatch, cell):
    """Replies routed to the wrong request: the scheduler's rows reversed
    after the device call."""
    from a_nice_rag_tpu_torch.serving import scheduler

    real = scheduler.BatchScheduler._run_batch

    def reversed_rows(self, batch):
        out = real(self, batch)
        return out[::-1] if len(out) > 1 else [
            (o[0][::-1], o[1][::-1]) if o[0].ndim == 2 else o for o in out]

    monkeypatch.setattr(scheduler.BatchScheduler, "_run_batch",
                        reversed_rows)
    out = _rehearse(cell)
    assert not out["correct"]
    assert out["checks"]["route_err"]["value"] > 0


def test_routing_fault_is_caught(monkeypatch):
    _routing_fault(monkeypatch, "msmarco-q1024-int8.frames")


@pytest.mark.parametrize("cell", SHARDED)
def test_routing_fault_is_caught_sharded(monkeypatch, cell):
    _routing_fault(monkeypatch, cell)


def test_measuring_run_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", "--rehearse"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference one precision lower, in the program's place, on the
    rows a rehearsal run sampled: the harness's own verdict reads it not
    correct, while the program's own run passes every limit."""
    out = runner.run(load_cell(cell), SEED, 1.0, False, time.perf_counter(),
                     rehearse=True, control=True)
    limits = runner.rehearsal_config(load_cell(cell).config)["limits"]
    assert out["correct"]
    ctl = out["info"]["control"]
    assert out["info"]["control_correct"] is False, ctl
    assert any(v > limits[k] for k, v in ctl.items() if k in limits), ctl
    # Every number the program read, with or without a limit.
    assert set(limits) - {"missing", "route_err"} <= set(
        out["info"]["program"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    """A short run of the cell on a CUDA device: correct, with every
    end-to-end metric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"]
                                   for m in load_cell(cell).end_to_end}
