"""The probes of K1/K2, the keys and int4 (ops/kernels/anatomy.py,
keys.py, int4.py) against the JAX package's TPU probes, on the CPU.

The TPU kernels are the ``pl.pallas_call`` bodies of
``scripts/profile_kernel_anatomy.py`` (P4), ``probe_iteration_count.py``
(P5), ``probe_bf16_fold.py`` (P6), ``probe_int4.py`` (P7) and the key
kernel of ``tests/test_pallas_fused.py`` (T1). P4-P6 are closures inside
the scripts' ``main()``: each script runs as it is, at a small size (its
``sys.argv`` or its module's ``W`` patched), with ``pl.pallas_call``
wrapped so that every call runs in interpret mode and records its inputs
and outputs. On CPU tensors the port's wrappers take their plain
versions, which are what is compared here; the CUDA kernels are held
against those plain versions in ``test_torch_kernels_cuda.py``.

Tolerances: exact for the int8, int4 and key paths and for every id;
f32 scores within 1e-5 of the largest |score| (the same products summed
in another order), ids equal up to swaps inside that tolerance.

P4's ablation modes (stage, score, compare) compute functions the TPU
probe has no output for (its dma_only, mm_only and mm_trigger bodies keep
the tile live in their own ways), so the port's modes are held against a
direct numpy computation instead; P5's insertion counts likewise, against
a brute-force count from their definition (the TPU probe counts its own
fold's extraction iterations, another quantity).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from a_nice_rag_tpu_torch.ops.kernels import anatomy as A
from a_nice_rag_tpu_torch.ops.kernels import int4 as I
from a_nice_rag_tpu_torch.ops.kernels import keys as KEYS
from a_nice_rag_tpu_torch.probes import bf16_fold, iteration_count
from a_nice_rag_tpu_torch.probes import int4 as int4_probe
from a_nice_rag_tpu_torch.probes import kernel_anatomy
from a_nice_rag_tpu_torch.testing.parity import check_top_k

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
F32_RTOL = 1e-5
# N D B k bq bn sub: 4 doc tiles of 1024, 2 query blocks of 8.
SMALL_ARGV = ["4096", "128", "16", "8", "8", "1024", "2"]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_port_probe_test_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def recorder(monkeypatch):
    """Every pallas_call in interpret mode; [(body name, inputs, outputs)]
    of each call, as numpy arrays."""
    calls = []
    original = pl.pallas_call

    def recording(body, *args, **kwargs):
        kwargs["interpret"] = True
        fn = original(body, *args, **kwargs)
        name = getattr(body, "__name__", None) or body.func.__name__

        def call(*inputs):
            out = fn(*inputs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            calls.append((name, [np.asarray(x) for x in inputs],
                          [np.asarray(o) for o in outs]))
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", recording)
    return calls


def _run_main(monkeypatch, name):
    mod = _script(name)
    monkeypatch.setattr(sys, "argv", [name, *SMALL_ARGV])
    if hasattr(mod, "timeit"):
        monkeypatch.setattr(mod, "timeit", lambda fn: (fn(), 1.0)[1])
    mod.main()


def _by_name(calls, name):
    return [(ins, outs) for n, ins, outs in calls if n == name]


def _bf16(a):
    """A numpy bf16 (or f32) array as an exact torch bf16 tensor."""
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _check_full(vals, ids, want_vals, want_ids):
    scale = max(1.0, float(np.abs(want_vals).max()))
    check_top_k(torch.tensor(want_vals), torch.tensor(want_ids), vals, ids,
                F32_RTOL * scale)


# -- P4: the anatomy --------------------------------------------------------


def test_anatomy_full_matches_profile_kernel_anatomy(recorder, monkeypatch):
    _run_main(monkeypatch, "profile_kernel_anatomy")
    assert [n for n, _, _ in recorder] == [
        "visit_dma_only", "visit_mm_only", "visit_mm_trigger", "visit_full"]
    (q, emb), (want_v, want_i) = _by_name(recorder, "visit_full")[0]
    q, emb = _bf16(q), _bf16(emb)
    vals, ids = A.anatomy_top_k(emb, q, 8, "full")
    _check_full(vals, ids, want_v, want_i)
    # Every body saw the same inputs.
    for _, ins, _ in recorder:
        assert all(np.array_equal(a, b) for a, b in zip(ins, recorder[0][1]))


def _numpy_scores(emb, q):
    return (np.asarray(q.float(), np.float64)
            @ np.asarray(emb.float(), np.float64).T)


@pytest.mark.parametrize("n,d,b", [(4096, 128, 16), (3000 + 37, 40, 70),
                                   (129, 8, 1)])
def test_anatomy_modes_against_direct_computation(n, d, b):
    rng = np.random.default_rng(n + d)
    emb = _bf16(rng.standard_normal((n, d)))
    q = torch.tensor(rng.standard_normal((b, d)).astype(np.float32))
    scores = _numpy_scores(emb, q)
    scale = max(1.0, float(np.abs(scores).max()))
    # score: each row's best, within 1e-5 of max |score|.
    got = A.anatomy_top_k(emb, q, 8, "score").numpy()
    assert np.abs(got - scores.max(axis=1)).max() <= F32_RTOL * scale
    # compare: documents at or above a threshold no score lies near.
    s = np.sort(scores, axis=1)[:, ::-1]
    thr = ((s[:, min(5, n - 1)] + s[:, min(6, n - 1)]) / 2).astype(np.float32)
    thr[s[:, min(5, n - 1)] - s[:, min(6, n - 1)] <= 4 * F32_RTOL * scale] \
        = np.inf
    got = A.anatomy_top_k(emb, q, 8, "compare", torch.tensor(thr))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), (scores >= thr[:, None]).sum(axis=1))
    # stage: per CTA (query block, doc split) the XOR of the words staged
    # (each doc's f32 words once, the query block's once per tile).
    splits, per = A.split_plan(n, b, torch.device("cpu"))
    ew = np.asarray(emb.float()).view(np.uint32)
    qw = np.asarray(q).view(np.uint32)
    want = np.zeros((-(-b // 64), splits), np.uint32)
    for qb in range(want.shape[0]):
        qx = np.bitwise_xor.reduce(qw[64 * qb:64 * qb + 64].ravel())
        for sp in range(splits):
            docs = ew[sp * per:min(n, sp * per + per)]
            tiles = -(-docs.shape[0] // 128)
            want[qb, sp] = (np.bitwise_xor.reduce(docs.ravel())
                            ^ (qx if tiles % 2 else np.uint32(0)))
    got = A.anatomy_top_k(emb, q, 8, "stage")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_anatomy_int8_modes_against_direct_computation():
    rng = np.random.default_rng(3)
    n, d, b = 2000 + 3, 36, 9
    values = rng.integers(-127, 128, (n, d), dtype=np.int8)
    q_values = rng.integers(-127, 128, (b, d), dtype=np.int8)
    scales = rng.uniform(0.5, 1.5, n).astype(np.float32)
    q_scales = rng.uniform(0.5, 1.5, b).astype(np.float32)
    acc = q_values.astype(np.int64) @ values.astype(np.int64).T
    scores = acc.astype(np.float32) * scales[None, :]  # one rounding
    args = [torch.tensor(a) for a in (values, scales, q_values,
                                          q_scales)]
    got = A.anatomy_top_k_int8(*args, 25, "score").numpy()
    assert np.array_equal(got, scores.max(axis=1))
    thr = torch.tensor(np.median(scores, axis=1).astype(np.float32))
    got = A.anatomy_top_k_int8(*args, 25, "compare", thr)
    assert np.array_equal(got.numpy(),
                          (scores >= thr.numpy()[:, None]).sum(axis=1))
    words = np.pad(values, ((0, 0), (0, -d % 4))).view(np.uint32)
    qx = np.bitwise_xor.reduce(np.pad(q_values, ((0, 0), (0, -d % 4)))
                               .view(np.uint32).ravel())
    splits, per = A.split_plan(n, b, torch.device("cpu"))
    got = A.anatomy_top_k_int8(*args, 25, "stage").numpy().view(np.uint32)
    for sp in range(splits):
        docs = words[sp * per:min(n, sp * per + per)]
        odd = -(-docs.shape[0] // 128) % 2
        assert got[0, sp] == (np.bitwise_xor.reduce(docs.ravel())
                              ^ (qx if odd else np.uint32(0)))
    vals, ids = A.anatomy_top_k_int8(*args, 25, "full")
    order = np.lexsort((np.arange(n)[None, :].repeat(b, 0), -scores))[:, :25]
    assert np.array_equal(ids.numpy(), order)
    assert np.array_equal(
        vals.numpy(), np.take_along_axis(scores, order, 1) * q_scales[:, None])


# -- P5: the counted fold ---------------------------------------------------


@pytest.mark.parametrize("tau_quantile", [None, "64"])
def test_counted_fold_matches_probe_iteration_count(recorder, monkeypatch,
                                                    tau_quantile):
    if tau_quantile is None:
        monkeypatch.delenv("TAU_QUANTILE", raising=False)
    else:
        monkeypatch.setenv("TAU_QUANTILE", tau_quantile)
    _run_main(monkeypatch, "probe_iteration_count")
    ((q, emb, tau), (want_v, want_i, _)), = _by_name(recorder, "kernel")
    q, emb = _bf16(q), _bf16(emb)
    seed = None if tau_quantile is None else torch.tensor(tau[:, 0])
    vals, ids, counts = A.fused_top_k_counted(emb, q, 8, seed)
    _check_full(vals, ids, want_v, want_i)
    # The warm start changes no id, and only removes insertions.
    ref_v, ref_i, ref_counts = A.fused_top_k_counted(emb, q, 8)
    assert torch.equal(ids, ref_i) and torch.equal(vals, ref_v)
    assert bool((counts[..., :2].sum(-1) <= ref_counts[..., :2].sum(-1)).all())
    own_tau = A.subsample_tau(emb, q, 8)
    assert torch.equal(A.fused_top_k_counted(emb, q, 8, own_tau)[1], ref_i)


def _brute_counts(scores, k, per, splits, tau=None):
    """Insertions per row and split from their definition: doc j of a
    split enters iff fewer than k earlier docs of the split score at least
    as high (earlier ids win ties) and, with tau, it scores at least tau.
    Returns [B, len(splits), 3]: insertions in the split's first 16 tiles,
    after them, and fired 32-column windows."""
    b, n = scores.shape
    out = np.zeros((b, len(splits), 3), np.int64)
    for r in range(b):
        for col, sp in enumerate(splits):
            s = scores[r, sp * per:min(n, sp * per + per)]
            m = s.shape[0]
            earlier = np.tri(m, m, -1, dtype=bool)  # [j, i]: i before j
            beaten = ((s[None, :] >= s[:, None]) & earlier).sum(axis=1)
            entered = beaten < k
            if tau is not None:
                entered &= s >= tau[r]
            pos = np.arange(m)
            out[r, col, 0] = (entered & (pos < 16 * 128)).sum()
            out[r, col, 1] = (entered & (pos >= 16 * 128)).sum()
            # A window fires iff its best document (the first of its
            # maxima) enters.
            out[r, col, 2] = sum(entered[w + int(np.argmax(s[w:w + 32]))]
                                for w in range(0, m, 32))
    return out


@pytest.mark.parametrize("use_tau", [False, True])
def test_counted_fold_insertions_against_their_definition(use_tau):
    # Integer scores: exact, with ties everywhere. Splits of 18 tiles (an
    # H100's plan at B <= 64), so a split has early and late tiles.
    rng = np.random.default_rng(11)
    n, d, b, k = 862_000, 4, 2, 4
    emb = torch.tensor(rng.integers(-2, 3, (n, d)).astype(np.float32))
    q = torch.tensor(rng.integers(-2, 3, (b, d)).astype(np.float32))
    scores = (q @ emb.T).numpy()
    splits, per = A.split_plan(n, b, torch.device("cpu"))
    assert per == 18 * 128
    tau = A.subsample_tau(emb, q, k) if use_tau else None
    vals, ids, counts = A.fused_top_k_counted(emb, q, k, tau)
    picked = [0, 1, splits // 2, splits - 1]
    want = _brute_counts(scores, k, per, picked,
                         None if tau is None else tau.numpy())
    assert np.array_equal(counts[:, picked, :3].numpy(), want)
    assert int(counts[..., 1].sum()) > 0
    seen = [-(-min(per, n - sp * per) // 128) * 4 for sp in range(splits)]
    assert np.array_equal(counts[..., 3].numpy(), np.tile(seen, (b, 1)))
    assert bool((counts[..., 2] <= counts[..., 3]).all())
    assert bool((counts[..., 2] <= counts[..., :2].sum(-1)).all())
    ref = A.fused_dense_top_k(emb, q, k)
    assert torch.equal(ids, ref[1]) and torch.equal(vals, ref[0])


def test_counted_fold_int8_matches_k2():
    rng = np.random.default_rng(12)
    n, d, b, k = 4000, 16, 5, 25
    args = [torch.tensor(a) for a in (
        rng.integers(-127, 128, (n, d), dtype=np.int8),
        rng.uniform(0.5, 1.5, n).astype(np.float32),
        rng.integers(-127, 128, (b, d), dtype=np.int8),
        rng.uniform(0.5, 1.5, b).astype(np.float32))]
    ref = A.fused_dense_top_k_int8(*args, k)
    tau = A.subsample_tau_int8(args[0], args[1], args[2], k)
    for t in (None, tau):
        vals, ids, counts = A.fused_top_k_counted_int8(*args, k, t)
        assert torch.equal(ids, ref[1]) and torch.equal(vals, ref[0])
        assert counts.shape == (b, A.split_plan(n, b, torch.device("cpu"))[0],
                                4)


# -- P6: bf16 row reductions and the packed key ------------------------------


def test_bf16_row_reduce_matches_probe_bf16_fold(recorder, monkeypatch):
    probe = _script("probe_bf16_fold")
    monkeypatch.setattr(probe, "W", 512)  # B stays 128: out_shape binds it
    probe.main()
    names = [n for n, _, _ in recorder]
    assert names == ["bf16_max", "bf16_argpick", "bf16_mask_write", "packed",
                     "packed"]
    for i, name in enumerate(("max", "arg", "second", "packed_arg")):
        ((x,), (out,)) = _by_name(recorder, names[i])[0]
        got = KEYS.bf16_row_reduce(torch.tensor(x))[i]
        assert np.array_equal(got.numpy().astype(np.float32), out[:, 0]), name
    ((x,), (out,)) = _by_name(recorder, "packed")[1]  # the cross-check's x
    got = KEYS.bf16_row_reduce(torch.tensor(x))[3].numpy()
    assert np.array_equal(got, out[:, 0].astype(np.int32))
    ref = np.asarray(jnp.argmax(jnp.asarray(x).astype(jnp.bfloat16), axis=1))
    assert np.array_equal(got, ref)


def test_bf16_fold_probe_runs_on_the_cpu():
    lines = bf16_fold.run(torch.device("cpu"), lambda fn, n: (fn(), 1.0)[1],
                          shapes=((4, 300), (2, 65_536)))
    assert [line["shape"] for line in lines] == [[4, 300], [2, 65_536]]
    assert all(line["packed_argmax_agreement"] == 1.0 for line in lines)


# -- P7: int4 ----------------------------------------------------------------


def test_int4_scores_match_probe_int4_stages_1_and_3(recorder):
    probe = _script("probe_int4")
    probe.stage1()
    probe.stage3()
    calls = _by_name(recorder, "_score_kernel")
    assert len(calls) == 2  # the i8shift and i32mask unpacks
    for (q8, packed), (want,) in calls:
        qt, pt = torch.tensor(q8), torch.tensor(packed)
        for unpack in I.UNPACKS:
            assert np.array_equal(I.int4_scores(qt, pt, unpack).numpy(), want)
        e4 = I.unpack_int4(pt)
        assert np.array_equal(I.pack_int4(e4).numpy(), packed)
        assert np.array_equal(probe.pack_int4(e4.numpy()), packed)
    for body in ("kernel", "kernel_up"):  # stage 3: native int4 rows
        ((q8, e_i4), (want,)), = _by_name(recorder, body)
        e4 = torch.tensor(np.asarray(e_i4, np.int8))
        packed = I.pack_int4(e4)
        got = I.int4_scores(torch.tensor(q8), packed)
        assert np.array_equal(got.numpy(), want)


class _Unjitted:
    """The jax module with ``jit`` the identity."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, *args, **kwargs):
        return fn


def test_int4_folds_match_probe_int4_stage_2(recorder, monkeypatch):
    probe = _script("probe_int4")
    monkeypatch.setattr(probe, "chained_dispatch_ms",
                        lambda fn, n, trials: (fn(), 1.0)[1])
    # Unjitted, so that the recorder sees arrays rather than tracers.
    monkeypatch.setattr(probe, "jax", _Unjitted())
    probe.stage2(n=2048, d=256, b=16, bn=512, unpack_name="i32mask")
    ((q8, e8), (want8,)), = _by_name(recorder, "_fold_kernel_int8")
    ((q8b, packed), (want4,)), = _by_name(recorder, "_fold_kernel_int4")
    q = torch.tensor(q8)
    assert np.array_equal(q8, q8b)
    assert np.array_equal(I.int8_fold_max(q, torch.tensor(e8)).numpy(),
                          want8[:, 0])
    for unpack in I.UNPACKS:
        got = I.int4_fold_max(q, torch.tensor(packed), unpack)
        assert np.array_equal(got.numpy(), want4[:, 0])


def test_int4_probe_exact_and_stage_2_on_the_cpu():
    line = int4_probe.check_exact(torch.device("cpu"))
    assert line["exact"]
    q8, packed = int4_probe.stage2_inputs(torch.device("cpu"), n=3000, d=64,
                                          b=5)
    e8 = torch.randint(-127, 128, (3000, 64), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(1))
    lines = int4_probe.run_stage2(q8, e8, packed,
                                  lambda fn, n: (fn(), 1.0)[1])
    assert [line["rows"] for line in lines] == ["int8", "int4"]
    assert lines[1]["speedup_vs_int8"] == 1.0


# -- T1: the key map ----------------------------------------------------


def test_xpack_keys_match_the_jax_key_kernel():
    from a_nice_rag_tpu.ops.pallas.fused_topk import (
        _xpack_scores,
        unpack_xpack_vals,
    )

    vals = np.array(
        [-np.inf, -3.3e38, -1.0, -2e-38, -1e-45, -0.0, 0.0, 1e-45,
         2e-38, 0.5, 1.0, 3.3e38, np.inf], np.float32,
    )
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        vals, (rng.standard_normal(4096) * 10).astype(np.float32)
    ])

    def _key_kernel(x_ref, o_ref):
        o_ref[:, :] = _xpack_scores(x_ref[:, :])

    pad = (-len(vals)) % 128
    v2 = np.pad(vals, (0, pad)).reshape(1, -1)
    keys2 = pl.pallas_call(
        _key_kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(v2.shape, jnp.int32),
        interpret=True,
    )(jnp.asarray(v2))
    want = np.asarray(keys2).ravel()[:len(vals)]
    x = torch.tensor(vals)
    keys = KEYS.xpack_keys(x)
    assert keys.dtype == torch.int32
    assert np.array_equal(keys.numpy(), want)  # bit for bit
    back = KEYS.xpack_values(keys)
    assert back.numpy().tobytes() == vals.tobytes()
    jax_back = np.asarray(unpack_xpack_vals(jnp.asarray(want)))
    assert back.numpy().tobytes() == jax_back.tobytes()
    ordered = vals[np.argsort(keys.numpy(), kind="stable")]
    assert (ordered[1:] >= ordered[:-1]).all()


# -- the probes themselves -------------------------------------------------


def test_anatomy_threshold_lies_in_a_wide_gap():
    """The compare check's threshold: halfway across the last gap wider
    than the tolerance in each row's top-k list, or above the best entry
    when the list has no such gap (exact values)."""
    top = torch.tensor([[5.0, 4.0, 3.0, 3.0, 2.99999],
                        [7.0, 7.0, 7.0, 7.0, 7.0],
                        [9.0, 1.0, 1.0, 1.0, 1.0]])
    thr = kernel_anatomy._threshold(top, 1e-3)
    assert torch.equal(thr, torch.tensor([3.5, 7.0 + 1e-3, 5.0]))
    assert thr.is_contiguous() and thr.shape == (3,)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_kernel_anatomy_probe_runs_on_the_cpu(kind):
    rows, q, k, scales, q_scales = kernel_anatomy.make_rows(
        kind, 3000, torch.device("cpu"))
    err = kernel_anatomy.check(rows, q, k, scales, q_scales)
    assert err <= F32_RTOL * 100 if scales is None else err == 0.0
    line = kernel_anatomy.run(rows, q, k, lambda fn, n: (fn(), 1.0)[1],
                              scales, q_scales)
    assert set(line["ms"]) == set(A.MODES)
    assert line["loads_ms"] + line["scoring_ms"] + line["compare_ms"] \
        + line["insert_merge_ms"] == line["ms"]["full"]


def test_iteration_count_probe_runs_on_the_cpu():
    rows, q, k, scales, q_scales = kernel_anatomy.make_rows(
        "int8", 3000, torch.device("cpu"))
    lines = iteration_count.run(rows, q[:4], k, lambda fn, n: (fn(), 1.0)[1],
                                scales, q_scales[:4])
    assert [line["tau"] for line in lines] == [False, True]
    assert lines[1]["insertions_per_row"] <= lines[0]["insertions_per_row"]
    assert all(0 < line["fired_share"] <= 1 for line in lines)
