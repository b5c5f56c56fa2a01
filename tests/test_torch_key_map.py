"""T1's launch plan and plain versions (ops/kernels/keys.py) on the CPU.

``key_plan`` splits n words into a head (before the input's first
16-byte boundary), whole 16-byte vectors and a tail; the kernel's
threads take them as ``csrc/keys.cu``'s ``flip_kernel`` does (head word
t, vectors t, t + stride, ... in batches of ``unroll``, tail word t),
which is enumerated here: every word once, the vectors on the input's
16-byte grid. The plain versions are held bit for bit against the JAX
package's key map (``_xpack_scores`` in a ``pallas_call`` run in
interpret mode, as its own test runs it, and ``unpack_xpack_vals``) on
views at every word offset of a buffer; the CUDA kernel is held against
them in ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from a_nice_rag_tpu_torch.ops.kernels import keys as KEYS

SPECIAL = np.array([-np.inf, -3.3e38, -1.0, -2e-38, -1e-45, -0.0, 0.0, 1e-45,
                    2e-38, 0.5, 1.0, 3.3e38, np.inf], np.float32)
N_MAX = 67


def _covered(plan, n, threads):
    """How often the kernel's threads take each of the n words: thread
    tid of the grid's stride = grid * threads takes head word tid,
    vectors i + u * stride for i = tid, tid + unroll * stride, ... (u <
    unroll) and tail word tid."""
    seen = np.zeros(n, np.int64)
    stride, n_vec = plan.grid * threads, plan.vectors
    for tid in range(stride):
        if tid < plan.head:
            seen[tid] += 1
        for i in range(tid, n_vec, plan.unroll * stride):
            for u in range(plan.unroll):
                j = i + u * stride
                if j < n_vec:
                    seen[plan.head + 4 * j:plan.head + 4 * j + 4] += 1
        if plan.head + 4 * n_vec + tid < n:
            seen[plan.head + 4 * n_vec + tid] += 1
    return seen


@pytest.mark.parametrize("unroll", KEYS.KEY_UNROLLS)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_key_plan_covers_each_word_once(offset, unroll):
    for n in range(N_MAX + 1):
        plan = KEYS.key_plan(n, offset, 2, unroll)
        assert plan.head + 4 * plan.vectors + plan.tail == n
        assert plan.head <= 3 and plan.tail <= 3 and plan.grid >= 1
        assert plan.head == min(n, (4 - offset) % 4)
        if plan.vectors:  # the body starts on the 16-byte grid
            assert (offset + plan.head) % 4 == 0
        assert (_covered(plan, n, KEYS.KEY_THREADS) == 1).all(), (n, plan)
    # Batches past the grid: 2 CTAs take 5 batches and a ragged last one.
    n = 4 * (5 * 2 * KEYS.KEY_THREADS * unroll + 37) + 6
    plan = KEYS.key_plan(n, offset, 1, unroll, ctas_per_sm=2)
    assert plan.grid == 2
    assert (_covered(plan, n, KEYS.KEY_THREADS) == 1).all()


def test_key_plan_grid():
    sms = 132
    big = KEYS.key_plan((1 << 24) + 13, 0, sms)
    assert big == KEYS.KeyPlan(0, (1 << 22) + 3, 1, KEYS.KEY_UNROLL,
                               KEYS.KEY_CTAS_PER_SM * sms)
    assert KEYS.key_plan((1 << 24) + 13, 0, sms, 4, 8).grid == 8 * sms
    # Fewer CTAs than the card holds where the vectors need fewer.
    assert KEYS.key_plan(5, 0, sms).grid == 1
    assert KEYS.key_plan(0, 2, sms) == KEYS.KeyPlan(0, 0, 0,
                                                    KEYS.KEY_UNROLL, 1)
    per_cta = KEYS.KEY_THREADS * KEYS.KEY_UNROLL
    assert KEYS.key_plan(4 * per_cta + 5, 3, sms).grid == 2
    for bad in ((-1, 0), (4, 4), (4, -1)):
        with pytest.raises(ValueError):
            KEYS.key_plan(*bad, sms)
    with pytest.raises(ValueError):
        KEYS.key_plan(4, 0, sms, unroll=2)


@pytest.fixture(scope="module")
def jax_keys():
    """A buffer of the 13 special values and normals (numpy, seeded), its
    keys from the JAX package's key map in interpret mode and their
    values from its inverse; the maps are elementwise, so a view's are
    the same slice of these."""
    from a_nice_rag_tpu.ops.pallas.fused_topk import (
        _xpack_scores,
        unpack_xpack_vals,
    )

    rng = np.random.default_rng(22)
    vals = np.concatenate([
        SPECIAL, (rng.standard_normal(128 - len(SPECIAL)) * 10)
        .astype(np.float32)])

    def _key_kernel(x_ref, o_ref):
        o_ref[:, :] = _xpack_scores(x_ref[:, :])

    keys = pl.pallas_call(
        _key_kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.int32),
        interpret=True,
    )(jnp.asarray(vals.reshape(1, -1)))
    return (vals, np.asarray(keys).ravel(),
            np.asarray(unpack_xpack_vals(keys)).ravel())


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, N_MAX])
def test_plain_key_map_matches_jax_at_offsets(jax_keys, n, offset):
    vals, want, jax_back = (a[offset:offset + n] for a in jax_keys)
    x = torch.tensor(jax_keys[0])[offset:offset + n]  # a 64-byte-aligned
    if n:                                             # buffer's view
        assert x.data_ptr() % 16 // 4 == offset
    keys = KEYS.xpack_keys(x)  # CPU tensors: the plain versions
    assert keys.dtype == torch.int32 and keys.shape == (n,)
    assert np.array_equal(keys.numpy(), want)
    back = KEYS.xpack_values(keys)
    assert back.numpy().tobytes() == vals.tobytes() == jax_back.tobytes()
