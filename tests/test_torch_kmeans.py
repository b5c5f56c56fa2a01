"""The port's spherical k-means against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages. The two
multiply in the same precision (f32 rows in f32; bf16 and int8 rows
against bf16-rounded centroids, every product exact in f32) and sum in
another order, so:

* scores and centroids agree within 1e-5;
* assignments agree except on rows whose two best centroid scores lie
  within 1e-5 of each other (an argmax that a summation order can flip).

The port cannot reproduce ``jax.random.choice``, so ``spherical_kmeans``
runs from the JAX package's initial rows (``init``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.ops import kmeans as jk
from a_nice_rag_tpu.ops.quantized import quantize_embeddings
from a_nice_rag_tpu_torch.ops import kmeans as tk

ATOL = 1e-5
DTYPES = ["float32", "bfloat16", "int8"]


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(n, d, c_true, seed):
    rng = np.random.default_rng(seed)
    cents = _unit(rng.normal(size=(c_true, d)))
    which = rng.integers(0, c_true, n)
    return _unit(cents[which] + 0.1 * rng.normal(size=(n, d))).astype(
        np.float32)


def _both(x, dtype):
    """The same rows as (jax array, torch tensor) in ``dtype``."""
    if dtype == "int8":
        vals = np.array(quantize_embeddings(jnp.asarray(x)).values)
        return jnp.asarray(vals), torch.as_tensor(vals)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    return jx, tx


def _init(x, c, seed):
    rows = np.asarray(jk.kmeans_init_rows(len(x), c, seed))
    return _unit(x[rows]).astype(np.float32)


def _near_ties(x_f32, cent):
    """Rows whose two best centroid scores lie within ATOL."""
    s = np.sort(x_f32 @ np.asarray(cent, np.float64).T, axis=1)
    return (s[:, -1] - s[:, -2]) <= ATOL


def _assert_assign_equal(got, want, ties):
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    assert not (diff & ~ties).any(), np.flatnonzero(diff & ~ties)[:10]


@pytest.mark.parametrize("dtype", DTYPES)
def test_lloyd_iter_matches_jax(dtype):
    x = _corpus(1000, 24, 8, seed=5)
    xp = np.zeros((1024, 24), np.float32)
    xp[:1000] = x
    jx, tx = _both(xp, dtype)
    cent = _init(x, 8, seed=3)
    jc, jn = jk._lloyd_iter(jx, jnp.asarray(cent), jnp.int32(1000), 256)
    tc, tn = tk._lloyd_iter(tx, torch.as_tensor(cent), 1000, 256)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_matches_jax(dtype):
    x = _corpus(512, 16, 6, seed=7)
    jx, tx = _both(x, dtype)
    cent = _init(x, 6, seed=1)
    want = jk._assign(jx, jnp.asarray(cent), 128)
    got = tk._assign(tx, torch.as_tensor(cent), 128)
    assert got.dtype == torch.int32
    xf = np.asarray(jx.astype(jnp.float32))
    _assert_assign_equal(got, want, _near_ties(xf, cent))


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_clusters_top2_matches_jax(dtype):
    x = _corpus(700, 16, 6, seed=9)  # not a chunk multiple
    jx, tx = _both(x, dtype)
    cent = _init(x, 6, seed=2)
    jids, jscs = jk.assign_clusters(jx, jnp.asarray(cent), top=2, chunk=256)
    tids, tscs = tk.assign_clusters(tx, torch.as_tensor(cent), top=2,
                                    chunk=256)
    assert tids.shape == (700, 2)
    np.testing.assert_allclose(tscs.numpy(), np.asarray(jscs), atol=ATOL)
    xf = np.asarray(jx.astype(jnp.float32))
    s = np.sort(xf @ cent.T.astype(np.float64), axis=1)
    # Rows whose 1st/2nd or 2nd/3rd best scores nearly tie may differ.
    ties = (s[:, -1] - s[:, -2] <= ATOL) | (s[:, -2] - s[:, -3] <= ATOL)
    for col in range(2):
        _assert_assign_equal(tids[:, col], np.asarray(jids)[:, col], ties)


@pytest.mark.parametrize("dtype", DTYPES)
def test_spherical_kmeans_from_jax_init(dtype):
    x = _corpus(1500, 32, 10, seed=11)
    jx, tx = _both(x, dtype)
    jc, ja = jk.spherical_kmeans(jx, 10, n_iters=6, seed=4, chunk=512)
    init = _init(np.asarray(jx.astype(jnp.float32)), 10, seed=4)
    tc, ta = tk.spherical_kmeans(tx, 10, n_iters=6, seed=4, chunk=512,
                                 init=torch.as_tensor(init))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    xf = np.asarray(jx.astype(jnp.float32))
    _assert_assign_equal(ta, ja, _near_ties(xf, np.asarray(jc)))
    np.testing.assert_allclose(np.linalg.norm(tc.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_kmeans_init_rows_are_distinct_and_seeded():
    a = tk.kmeans_init_rows(1000, 40, seed=3)
    assert len(set(a.tolist())) == 40 and int(a.max()) < 1000
    assert torch.equal(a, tk.kmeans_init_rows(1000, 40, seed=3))
    assert not torch.equal(a, tk.kmeans_init_rows(1000, 40, seed=4))


def test_kmeans_handles_padding_and_tiny_inputs():
    rng = np.random.default_rng(0)
    x = _unit(rng.normal(size=(37, 16))).astype(np.float32)  # odd N
    cent, assign = tk.spherical_kmeans(torch.as_tensor(x), 5, n_iters=4)
    assert assign.shape == (37,) and int(assign.max()) < 5
    expect = np.argmax(x @ cent.numpy().T, axis=1)
    np.testing.assert_array_equal(assign.numpy(), expect)
