"""The fused score+top-k contract (K1 f32/bf16, K2 int8) of the port.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held against the JAX package's TPU kernels run in interpret mode, on
the same seeded inputs. The CUDA kernels themselves are held against the
plain versions in tests/test_torch_kernels_cuda.py, which skips without
a GPU.

Tolerances: f32 values 1e-5 (same products, another summation order);
int8 values exact (integer accumulation, then the same two f32
multiplies in the same order). Ids agree up to swaps between scores
within the tolerance (exact ties at atol 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.ops.pallas import (
    fused_dense_top_k as jax_fused,
    fused_dense_top_k_int8 as jax_fused_int8,
)
from a_nice_rag_tpu.ops.quantized import quantize_embeddings, quantize_queries
from a_nice_rag_tpu_torch.ops.kernels import (
    fused_dense_top_k,
    fused_dense_top_k_int8,
)
from a_nice_rag_tpu_torch.testing.parity import check_top_k

F32_ATOL = 1e-5


def _t(x, device="cpu"):
    return torch.as_tensor(np.array(x), device=device)


def _int8_inputs(rng, n, d, b):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    qd = quantize_embeddings(jnp.asarray(emb))
    qv, qs = quantize_queries(jnp.asarray(q))
    return qd, qv, qs


def test_fused_matches_jax_kernel():
    rng = np.random.default_rng(111)
    emb = rng.standard_normal((1024, 128)).astype(np.float32)
    q = rng.standard_normal((64, 128)).astype(np.float32)
    jv, ji = jax_fused(jnp.asarray(emb), jnp.asarray(q), k=16, block_q=64,
                       block_n=256, interpret=True)
    before = fused_dense_top_k.launches
    tv, ti = fused_dense_top_k(_t(emb), _t(q), 16)
    check_top_k(jv, ji, tv, ti, F32_ATOL)
    assert fused_dense_top_k.launches == before  # CPU: the plain version


def test_fused_with_mask():
    rng = np.random.default_rng(113)
    emb = rng.standard_normal((512, 64)).astype(np.float32)
    q = rng.standard_normal((64, 64)).astype(np.float32)
    mask = np.zeros(512, bool)
    mask[100:300] = True
    jv, ji = jax_fused(jnp.asarray(emb), jnp.asarray(q), k=8, block_q=64,
                       block_n=128, mask=jnp.asarray(mask), interpret=True)
    tv, ti = fused_dense_top_k(_t(emb), _t(q), 8, mask=_t(mask))
    ti = ti.numpy()
    assert ((ti >= 100) & (ti < 300)).all()
    check_top_k(jv, ji, tv, ti, F32_ATOL)


def test_fused_k_larger_than_valid_entries():
    rng = np.random.default_rng(117)
    emb = rng.standard_normal((256, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    mask = np.zeros(256, bool)
    mask[:5] = True  # only 5 valid docs, k=8
    jv, ji = jax_fused(jnp.asarray(emb), jnp.asarray(q), k=8, block_q=64,
                       block_n=128, mask=jnp.asarray(mask), interpret=True)
    tv, ti = fused_dense_top_k(_t(emb), _t(q), 8, mask=_t(mask))
    tv, ti = tv.numpy(), ti.numpy()
    assert (ti[:, :5] < 5).all() and (ti[:, :5] >= 0).all()
    assert np.isneginf(tv[:, 5:]).all()
    assert (ti[:, 5:] == -1).all()
    check_top_k(jv, ji, tv, ti, F32_ATOL)


def test_fused_more_slots_than_docs():
    rng = np.random.default_rng(119)
    emb = rng.standard_normal((7, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    tv, ti = fused_dense_top_k(_t(emb), _t(q), 12)
    assert (ti[:, 7:] == -1).all() and torch.isneginf(tv[:, 7:]).all()
    assert sorted(ti[0, :7].tolist()) == list(range(7))


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
def test_fused_misaligned_doc_axis(emb_dtype):
    rng = np.random.default_rng(121)
    emb = rng.standard_normal((1500, 40)).astype(np.float32)
    q = rng.standard_normal((8, 40)).astype(np.float32)
    jemb = jnp.asarray(emb, dtype=jnp.dtype(emb_dtype))
    temb = _t(emb).to(getattr(torch, emb_dtype))
    jv, ji = jax_fused(jemb, jnp.asarray(q), k=10, block_q=8,
                       block_n=1024, interpret=True)
    tv, ti = fused_dense_top_k(temb, _t(q), 10)
    check_top_k(jv, ji, tv, ti, F32_ATOL)


def test_fused_tie_fuzz_lower_id_wins():
    """Exact ties (duplicated rows, coarse values), also across the k
    boundary: the plain version keeps (score desc, id asc), and agrees
    with the TPU kernel up to the order among exactly equal scores."""
    rng = np.random.default_rng(977)
    for n, d, b, k in [(640, 8, 8, 16), (1300, 4, 5, 33), (300, 2, 3, 128)]:
        base = rng.integers(-2, 3, size=(n // 4, d)).astype(np.float32)
        emb = base[rng.integers(0, base.shape[0], size=n)]
        q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
        mask = rng.random(n) < 0.9
        jv, ji = jax_fused(jnp.asarray(emb), jnp.asarray(q), k=k, block_q=b,
                           block_n=1024, mask=jnp.asarray(mask),
                           interpret=True)
        tv, ti = fused_dense_top_k(_t(emb), _t(q), k, mask=_t(mask))
        check_top_k(jv, ji, tv, ti, 0.0)
        full = q @ emb.T
        full[:, ~mask] = -np.inf
        for r in range(b):
            order = np.lexsort((np.arange(n), -full[r]))[:k]
            np.testing.assert_array_equal(ti[r].numpy(), order)


def test_fused_int8_matches_jax_kernel():
    rng = np.random.default_rng(211)
    qd, qv, qs = _int8_inputs(rng, 1024, 128, 64)
    jv, ji = jax_fused_int8(qd.values, qd.scales, qv, qs, k=10, block_q=64,
                            block_n=256, interpret=True)
    before = fused_dense_top_k_int8.launches
    tv, ti = fused_dense_top_k_int8(_t(qd.values), _t(qd.scales), _t(qv),
                                    _t(qs), 10)
    check_top_k(jv, ji, tv, ti, 0.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert fused_dense_top_k_int8.launches == before


def test_fused_int8_with_mask():
    rng = np.random.default_rng(213)
    qd, qv, qs = _int8_inputs(rng, 512, 64, 64)
    mask = np.zeros(512, bool)
    mask[200:400] = True
    jv, ji = jax_fused_int8(qd.values, qd.scales, qv, qs, k=5, block_q=64,
                            block_n=128, mask=jnp.asarray(mask),
                            interpret=True)
    tv, ti = fused_dense_top_k_int8(_t(qd.values), _t(qd.scales), _t(qv),
                                    _t(qs), 5, mask=_t(mask))
    assert ((ti >= 200) & (ti < 400)).all()
    check_top_k(jv, ji, tv, ti, 0.0)


def test_fused_int8_misaligned_ragged_depth():
    rng = np.random.default_rng(215)
    qd, qv, qs = _int8_inputs(rng, 1100, 37, 6)
    mask = rng.random(1100) < 0.7
    jv, ji = jax_fused_int8(qd.values, qd.scales, qv, qs, k=20, block_q=2,
                            block_n=1024, mask=jnp.asarray(mask),
                            interpret=True)
    tv, ti = fused_dense_top_k_int8(_t(qd.values), _t(qd.scales), _t(qv),
                                    _t(qs), 20, mask=_t(mask))
    check_top_k(jv, ji, tv, ti, 0.0)


@pytest.mark.parametrize("bad", ["k_zero", "k_too_big", "dtype", "mask_shape",
                                 "depth"])
def test_fused_rejects_unsupported_calls(bad):
    emb = torch.zeros((10, 4))
    q = torch.zeros((2, 4))
    kwargs = {"k": 3}
    if bad == "k_zero":
        kwargs["k"] = 0
    elif bad == "k_too_big":
        kwargs["k"] = 129
    elif bad == "dtype":
        emb = emb.to(torch.float16)
    elif bad == "mask_shape":
        kwargs["mask"] = torch.ones(9, dtype=torch.bool)
    else:
        q = torch.zeros((2, 5))
    with pytest.raises((ValueError, TypeError)):
        fused_dense_top_k(emb, q, **kwargs)


def test_fused_int8_rejects_float_rows():
    with pytest.raises(TypeError):
        fused_dense_top_k_int8(
            torch.zeros((10, 4)), torch.ones(10),
            torch.zeros((2, 4), dtype=torch.int8), torch.ones(2), 3,
        )
