"""The generation driver (``systems/generation.py``) at its rehearsal size
on the CPU, over the fixture's cell staged as a later change would add
it: correct as the port serves it, and not correct with the timed path
broken underneath or with the control in the program's place."""

import hashlib
import json
import shutil
import time

import numpy as np

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.spec import BENCH_DIR, ROOT, load_cell
from benchmark.tests.fixtures import stage

from a_nice_rag_tpu_torch.models import decoder
from a_nice_rag_tpu_torch.serving import genserver

CELL = "qwen3-1.7b.rag-answer"
SEED = 2**31 + 977


def _copy_benchmark(dest):
    shutil.copytree(BENCH_DIR, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copyfile(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A copy of the benchmark with the fixture's files and entries."""
    root = tmp_path_factory.mktemp("staged")
    _copy_benchmark(root)
    stage.add_fixture(root)
    return root


def _rehearse(root, seed=SEED, control=False):
    cell = load_cell(CELL, root=root)
    return cell.driver.run(cell, seed, 1.0, False,
                                   time.perf_counter(), rehearse=True,
                                   control=control)


def _limits(root):
    from benchmark.harness.runner import rehearsal_config

    return rehearsal_config(load_cell(CELL, root=root).config)["limits"]


def test_rehearsal_is_correct(staged):
    out = _rehearse(staged)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "metrics" not in out and "device" not in out
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(_limits(staged))
    assert out["info"]["judged"] >= 1
    marks = out["info"]["setup_marks"]
    assert list(marks) == ["imports", "weights", "server", "warm"]
    assert list(marks.values()) == sorted(marks.values())
    # The cached system prompt serves every request of the window.
    w = out["info"]["window"]
    assert w["prefix_cache_hits"] == out["attempted"]
    assert w["tokens_emitted"] == out["attempted"] * 17


def test_control_is_not_correct(staged):
    out = _rehearse(staged, control=True)
    limits = _limits(staged)
    assert out["correct"], out["checks"]
    ctl = out["info"]["control"]
    assert out["info"]["control_correct"] is False, ctl
    assert any(v > limits[k] for k, v in ctl.items()), ctl
    assert {"logprob_gap", "topk_gap", "greedy_gap"} <= set(
        out["info"]["program"])


def _one_layer_perturbed(monkeypatch):
    """The MLP of the first decoder layer the program runs gives a fifth
    more than it should."""
    real = decoder._CachedBlock.mlp_out
    first = []

    def perturbed(self, x):
        out = real(self, x)
        if not first:
            first.append(self)
        return out * 1.2 if self is first[0] else out

    monkeypatch.setattr(decoder._CachedBlock, "mlp_out", perturbed)
    return ("logprob_gap",)


def _reply_cut(monkeypatch):
    """Every reply stops three tokens short, as if its budget were
    smaller."""
    monkeypatch.setattr(genserver.GenerationServer, "_is_stop",
                        lambda self, req, token: req.emitted
                        >= req.max_new_tokens - 3)
    return ("length_err",)


def _chunk_altered(alter):
    def fault(monkeypatch):
        real = genserver._decode_programs_dynamic

        def programs(model, eos_id, chunk, lp_k=0):
            steps = real(model, eos_id, chunk, lp_k)

            def altered(*args, **kw):
                outs = steps(*args, **kw)
                return (alter(outs[0], model.cfg.vocab_size),) + outs[1:]

            return altered

        monkeypatch.setattr(genserver, "_decode_programs_dynamic", programs)
        # A frozen slot's -1 copied into a live one also ends its reply.
        return ("logprob_gap", "length_err")

    return fault


def _token_altered(toks, vocab):
    """Each decoded token altered where it is produced."""
    return (toks + 1) % vocab


def _half_left_out(toks, vocab):
    """The upper half of the slots not decoded: they emit the lower
    half's tokens."""
    h = toks.shape[1] // 2
    toks = toks.clone()
    toks[:, h:2 * h] = toks[:, :h]
    return toks


def _state_unchanged(monkeypatch):
    """Decode steps leave the cache as it was (prefill writes stay)."""
    real = decoder.write_cache

    def write(cache, upd, cache_len):
        if upd.shape[1] > 1:
            real(cache, upd, cache_len)

    monkeypatch.setattr(decoder, "write_cache", write)
    return ("logprob_gap",)


FAULTS = [_one_layer_perturbed, _reply_cut, _chunk_altered(_token_altered),
          _chunk_altered(_half_left_out), _state_unchanged]


@pytest.mark.parametrize("fault", FAULTS, ids=[
    "one_layer_perturbed", "reply_cut", "token_altered", "half_left_out",
    "state_unchanged"])
def test_fault_makes_it_incorrect(staged, monkeypatch, fault):
    numbers = fault(monkeypatch)
    out = _rehearse(staged)
    assert not out["correct"], out["checks"]
    assert any(out["checks"][n]["value"] > out["checks"][n]["limit"]
               for n in numbers), out["checks"]


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_model_cell_is_new_files_and_entries_only(tmp_path):
    """A configuration, a traffic mix and an arch file, each new, with one
    new configs entry and one new workloads entry, rehearse correct; no
    file the benchmark had changes, and BENCHMARK.json only gains."""
    _copy_benchmark(tmp_path)
    before = _hashes(tmp_path)
    old_doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    fixture = stage.HERE / "generation"
    shutil.copyfile(bench / "archs" / "qwen3_dense.py",
                    bench / "archs" / "new_lm.py")
    cfg = json.loads((fixture / "configs" / "qwen3-1.7b.json").read_text())
    cfg.update(name="new-lm", arch="new_lm")
    (bench / "configs" / "new-lm.json").write_text(json.dumps(cfg))
    shutil.copyfile(fixture / "traffic" / "rag-answer.json",
                    bench / "traffic" / "new-answers.json")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "new-lm", "source": "x", "reduced": [],
                           "file": "benchmark/configs/new-lm.json",
                           "why": "x"})
    doc["workloads"].append({"name": "new-lm.new-answers", "config": "new-lm",
                             "traffic": "new-answers", "chips": 1,
                             "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    after = _hashes(tmp_path)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {tmp_path.joinpath("BENCHMARK.json").relative_to(
        tmp_path)}
    new_doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for group, entries in old_doc.items():
        if isinstance(entries, list):
            assert new_doc[group][:len(entries)] == entries
    assert len(new_doc["workloads"]) == len(old_doc["workloads"]) + 1

    cell = load_cell("new-lm.new-answers", root=tmp_path)
    assert cell.system == "generation"
    # The per-layer metrics its window feeds: the device trace's.
    assert [m["name"] for m in cell.per_layer] == ["device.idle_pct"]
    assert set(cell.readers) == {"device.idle_pct"}
    out = cell.driver.run(cell, SEED, 1.0, False,
                                  time.perf_counter(), rehearse=True)
    assert out["correct"], out["checks"]


def test_staging_refuses_to_replace_a_file(tmp_path):
    _copy_benchmark(tmp_path)
    stage.add_fixture(tmp_path)
    with pytest.raises(FileExistsError):
        stage.add_fixture(tmp_path)


def test_prompts_same_lengths_for_every_seed(staged):
    from benchmark.harness.runner import rehearsal_config

    cell = load_cell(CELL, root=staged)
    gen = spec.load_module(cell.bench_dir / "systems" / "generation.py",
                           "test_generation_driver_")
    traffic = dict(cell.traffic, **cell.config["rehearsal_traffic"])
    vocab = rehearsal_config(cell.config)["lm"]["vocab_size"]
    lens, sizes = {}, {}
    for seed in (1, SEED):
        prefix, pool, budgets = gen.prompts(traffic, vocab, genserver.PAD,
                                            seed)
        assert len(budgets) == len(pool)
        sizes[seed] = sorted(zip((len(p) for p in pool), budgets))
        assert len(prefix) == traffic["shared_prefix_tokens"]
        assert all(p[:len(prefix)] == prefix for p in pool)
        assert all(genserver.PAD not in p for p in pool)
        assert all(0 <= t < vocab for p in pool for t in p)
        lens[seed] = [len(p) for p in pool]
        # Each run of `clients` requests holds one length of each stratum.
        c = traffic["clients"]
        strata = torch.tensor(sorted(lens[seed])).reshape(c, -1)
        first = sorted(lens[seed][:c])
        assert all(int(strata[s].min()) <= first[s] <= int(strata[s].max())
                   for s in range(c))
    assert sorted(lens[1]) == sorted(lens[SEED]) and lens[1] != lens[SEED]
    assert sizes[1] == sizes[SEED]


def test_a_budget_law_gives_every_run_the_same_sizes(staged):
    """Each run of ``clients`` requests holds the same lengths and the
    same budgets for every seed, paired and ordered by the seed; over the
    pool, the budgets are the law's quantiles."""
    cell = load_cell(CELL, root=staged)
    gen = spec.load_module(cell.bench_dir / "systems" / "generation.py",
                           "test_generation_driver_")
    law = {"dist": "lognormal", "median": 96, "sigma": 0.5, "min": 24,
           "max": 256}
    traffic = dict(cell.traffic, new_tokens=law)
    c = traffic["clients"]
    orders = [gen.pool_order(traffic, seed) for seed in (1, SEED)]
    for order in orders:
        assert sorted(order[:, 1].tolist()) == gen.quantiles(
            law, traffic["pool_requests"], "new_tokens").tolist()
    a, b = (o.reshape(-1, c, 2) for o in orders)
    for axis in (0, 1):
        assert (np.sort(a[:, :, axis], 1) == np.sort(b[:, :, axis], 1)).all()
    assert a.tolist() != b.tolist()
    # Each run's budgets: one of each stratum.
    strata = gen.quantiles(law, traffic["pool_requests"],
                           "new_tokens").reshape(c, -1)
    for run in a[:, :, 1]:
        assert all(strata[s, 0] <= v <= strata[s, -1]
                   for s, v in enumerate(np.sort(run)))


def test_budgets_of_a_law_are_served_and_checked(tmp_path, monkeypatch):
    """Rehearsal traffic whose budgets follow a law: each reply runs its
    own budget, and replies cut short are length errors."""
    _copy_benchmark(tmp_path)
    stage.add_fixture(tmp_path)
    path = tmp_path / "benchmark" / "configs" / "qwen3-1.7b.json"
    cfg = json.loads(path.read_text())
    cfg["rehearsal_traffic"]["new_tokens"] = {
        "dist": "lognormal", "median": 12, "sigma": 0.5, "min": 4, "max": 40}
    path.write_text(json.dumps(cfg))
    out = _rehearse(tmp_path)
    assert out["correct"], out["checks"]
    assert out["info"]["window"]["tokens_emitted"] > 0
    _reply_cut(monkeypatch)
    out = _rehearse(tmp_path)
    assert not out["correct"] and out["checks"]["length_err"]["value"] > 0


def test_traced_rehearsal_is_correct(staged):
    """The traced window (``runner.start_profile``, ``traced_window``)
    under the generation driver; the CPU trace holds no device operation,
    so no per-layer metric reads anything."""
    cell = load_cell(CELL, root=staged)
    out = cell.driver.run(cell, SEED, 1.0, True, time.perf_counter(),
                                  rehearse=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
