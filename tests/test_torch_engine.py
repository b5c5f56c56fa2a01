"""The port's FusedRetriever end to end against the JAX package's.

One synthetic corpus is indexed with the JAX package's ``build_index``;
the port gets the same index by ``from_reference_index`` and by a
``save_index`` -> port ``load_index`` round trip. Both retrievers run on
the same queries. Per-list ids must agree up to swaps between documents
whose exact (float64) scores lie within the tolerance: dense 1e-5, BM25
1e-4 (cumsum-difference segment totals, ops/bm25.py); the fused lists
then agree exactly, or within 1e-6 of fused score where a swap moved a
rank. The JAX side reaches its TPU kernels in interpret mode
(``dense_backend="pallas"`` off the TPU).
"""

import numpy as np
import pytest
import torch

from a_nice_rag_tpu.index import build_index, save_index
from a_nice_rag_tpu.retrieval.engine import FusedRetriever as JaxRetriever
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import from_reference_index, load_index
from a_nice_rag_tpu_torch.retrieval import FusedRetriever
from a_nice_rag_tpu_torch.testing.parity import check_top_k

MODELS = ("voyage-3-large", "text-embedding-3-large")
BACKENDS = {"pallas": "kernel", "xla": "torch", "auto": "auto"}
DENSE_ATOL = 1e-5
BM25_ATOL = 1e-4
FUSED_ATOL = 1e-6


@pytest.fixture(scope="module")
def corpus():
    return synth_corpus(n_docs=1200, dim=32, n_queries=12, seed=41,
                        vocab_size=300, models=list(MODELS))


def _jax_index(c, **kw):
    return build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                       embeddings=c.embeddings, token_lists=c.tokens, **kw)


def _exact_scores(jidx, model, q, terms, ids):
    """float64 scores of the given ids: [B, k], -inf where id is -1."""
    ids = np.asarray(ids)
    safe = np.maximum(ids, 0)
    if model == "BM25":
        indptr = np.asarray(jidx.bm25.indptr)
        doc_ids = np.asarray(jidx.bm25.doc_ids)
        impact = np.asarray(jidx.bm25.impact).astype(np.float64)
        full = np.zeros((terms.shape[0], jidx.n_docs_padded + 1))
        for b, row in enumerate(terms):
            for t in row[row >= 0]:
                lo, hi = indptr[t], indptr[t + 1]
                np.add.at(full[b], doc_ids[lo:hi], impact[lo:hi])
    elif model in jidx.dense:
        e = np.asarray(jidx.dense[model]).astype(np.float64)
        full = q.astype(np.float64) @ e.T
    else:
        qd = jidx.dense_q[model]
        from a_nice_rag_tpu.ops.quantized import quantize_queries

        qv, qs = (np.asarray(a) for a in quantize_queries(q))
        acc = qv.astype(np.float64) @ np.asarray(qd.values).astype(np.float64).T
        full = acc * np.asarray(qs)[:, None] * np.asarray(qd.scales)[None, :]
    vals = np.take_along_axis(full, safe, axis=1)
    return np.where(ids >= 0, vals, -np.inf)


def _compare(jidx, j_out, t_out, names, q_embs, terms):
    (jf, jfv, jl), (tf, tfv, tl) = j_out, t_out
    jl, tl = np.asarray(jl), np.asarray(tl)
    assert tl.shape == jl.shape
    same_lists = True
    for li, name in enumerate(names):
        q = q_embs.get(name)
        atol = BM25_ATOL if name == "BM25" else DENSE_ATOL
        swaps = check_top_k(
            _exact_scores(jidx, name, q, terms, jl[li]), jl[li],
            _exact_scores(jidx, name, q, terms, tl[li]), tl[li], atol,
        )
        same_lists &= swaps == 0
    if same_lists:
        np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))
        np.testing.assert_allclose(np.asarray(tfv), np.asarray(jfv),
                                   atol=FUSED_ATOL)
    else:
        check_top_k(jfv, jf, tfv, tf, FUSED_ATOL)


def _run_both(jidx, tidx, c, backend, model_names=MODELS, use_bm25=True,
              filt=None, **kw):
    jr = JaxRetriever(jidx, model_names, use_bm25=use_bm25, similarity_k=10,
                      common_sections_n=8, budget=8192,
                      dense_backend=backend, **kw)
    tr = FusedRetriever(tidx, model_names, use_bm25=use_bm25,
                        similarity_k=10, common_sections_n=8, budget=8192,
                        dense_backend=BACKENDS[backend], **kw)
    assert tr.use_kernel == jr.use_pallas
    q = {m: c.query_embeddings[m] for m in model_names}
    terms = jidx.pad_term_ids(c.query_tokens, 16) if use_bm25 else None
    w = {"voyage-3-large": 5.0, "text-embedding-3-large": 2.0, "BM25": 1.0}
    j_out = jr(q, terms, w, filt, 40.0)
    t_out = tr(q, terms, w, filt, 40.0)
    names = list(model_names) + (["BM25"] if use_bm25 else [])
    _compare(jidx, j_out, t_out, names, q, terms)
    return jr, tr, t_out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("filt", [None, "CG,NG"])
def test_engine_f32_matches_jax(corpus, backend, filt):
    jidx = _jax_index(corpus)
    _run_both(jidx, from_reference_index(jidx, device="cpu"), corpus, backend,
              filt=filt)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_engine_quantized_matches_jax(corpus, backend):
    jidx = _jax_index(corpus, quantize_dense=True)
    tidx = from_reference_index(jidx, device="cpu")
    assert tidx.dense_q and not tidx.dense
    _run_both(jidx, tidx, corpus, backend, filt="QS")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_engine_csr_only_matches_jax(corpus, backend):
    jidx = _jax_index(corpus, bm25_dense_max_bytes=0)
    tidx = from_reference_index(jidx, device="cpu")
    assert tidx.bm25_dense is None
    _run_both(jidx, tidx, corpus, backend, filt="NG")


def test_engine_two_tier_matches_jax(corpus):
    jidx = _jax_index(corpus, bm25_dense_max_bytes=0)
    jr, tr, _ = _run_both(jidx, from_reference_index(jidx, device="cpu"),
                          corpus, "pallas", filt="CG", two_tier_common=8)
    assert tr._two_tier is not None and tr._two_tier.v_common == 8
    assert tr._tt_rare_cap == jr._tt_rare_cap


def test_engine_two_tier_auto_sizing_matches_jax(corpus):
    jidx = _jax_index(corpus, bm25_dense_max_bytes=0)
    tidx = from_reference_index(jidx, device="cpu")
    for budget in (64, 256, 100_000):
        jr = JaxRetriever(jidx, MODELS, use_bm25=True, budget=budget,
                          dense_backend="pallas")
        tr = FusedRetriever(tidx, MODELS, use_bm25=True, budget=budget,
                            dense_backend="kernel")
        j_vc = None if jr._two_tier is None else jr._two_tier.v_common
        t_vc = None if tr._two_tier is None else tr._two_tier.v_common
        assert t_vc == j_vc, budget
        assert tr._tt_rare_cap == jr._tt_rare_cap


def test_engine_dense_only_and_bm25_only(corpus):
    jidx = _jax_index(corpus)
    tidx = from_reference_index(jidx, device="cpu")
    _run_both(jidx, tidx, corpus, "xla", model_names=MODELS[:1],
              use_bm25=False)
    _run_both(jidx, tidx, corpus, "pallas", model_names=(), filt="CG")


def test_engine_from_saved_artifact(corpus, tmp_path):
    # The JAX package writes bf16 matrices as raw 2-byte records (npz has
    # no bfloat16); the port reads them back bit for bit.
    jidx = _jax_index(corpus, emb_dtype="bfloat16")
    save_index(jidx, str(tmp_path))
    tidx = load_index(str(tmp_path), emb_dtype="bfloat16", device="cpu")
    assert tidx.dense[MODELS[0]].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tidx.dense[MODELS[0]].float().numpy(),
        np.asarray(jidx.dense[MODELS[0]]).astype(np.float32),
    )
    np.testing.assert_array_equal(tidx.bm25_dense.impact.numpy(),
                                  np.asarray(jidx.bm25_dense.impact))
    _run_both(jidx, tidx, corpus, "pallas", filt="CG,QS")


def test_port_artifact_loads_in_jax(corpus, tmp_path):
    from a_nice_rag_tpu.index import load_index as jax_load_index
    from a_nice_rag_tpu_torch.index import save_index as port_save_index

    jidx = _jax_index(corpus, emb_dtype="bfloat16", quantize_dense=[MODELS[1]])
    port_save_index(from_reference_index(jidx, device="cpu"), str(tmp_path))
    back = jax_load_index(str(tmp_path), emb_dtype="bfloat16")
    np.testing.assert_array_equal(
        np.asarray(back.dense[MODELS[0]]).astype(np.float32),
        np.asarray(jidx.dense[MODELS[0]]).astype(np.float32),
    )
    np.testing.assert_array_equal(np.asarray(back.dense_q[MODELS[1]].values),
                                  np.asarray(jidx.dense_q[MODELS[1]].values))


@pytest.mark.parametrize("n_pad", [1000, (1 << 19) - 1, 1 << 19, 3 << 20])
@pytest.mark.parametrize("k", [25, 128, 129])
@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("on_accelerator", [False, True])
def test_route_decision_matches_jax(n_pad, k, backend, on_accelerator):
    want = JaxRetriever._route_pallas(
        backend, n_pad, k, "tpu" if on_accelerator else "cpu"
    )
    got = FusedRetriever._route_kernel(
        BACKENDS[backend], n_pad, k, "cuda" if on_accelerator else "cpu"
    )
    assert got == want


def test_engine_rejects_ivf_and_unknown_backend(corpus):
    tidx = from_reference_index(_jax_index(corpus), device="cpu")
    with pytest.raises(ValueError, match="ivf_route"):
        FusedRetriever(tidx, MODELS, use_bm25=True, nprobe=4,
                       ivf_route="sometimes")
    with pytest.raises(ValueError):
        FusedRetriever(tidx, MODELS, use_bm25=True, dense_backend="pallas")


def test_engine_mask_threading_and_stale_eviction(corpus):
    jidx = _jax_index(corpus)
    tidx = from_reference_index(jidx, device="cpu")
    # 1200 docs pad to 1280 rows: the trivial mask is not all-true.
    assert tidx.filter_mask_or_none(None) is not None
    tr = FusedRetriever(tidx, MODELS, use_bm25=True, similarity_k=5,
                        common_sections_n=5)
    q = {m: corpus.query_embeddings[m] for m in MODELS}
    terms = tidx.pad_term_ids(corpus.query_tokens, 16)
    w = {"BM25": 1.0}
    fids, fvals, lists = tr.retrieve_device(q, terms, w, "CG")
    assert isinstance(fids, torch.Tensor) and fids.device == tidx.device
    for v in range(1, 4):
        tidx._version = v
        tr.retrieve_device(q, terms, w, "CG")
    keys = [k for k in tr._const_cache if k[0] == "bm25_mask"]
    assert keys == [("bm25_mask", "CG", 3)]
    rows = np.asarray(fids)
    cg = tidx.meta.filter_mask("CG")
    assert cg[rows[rows >= 0]].all()


def test_entry_points_default_to_the_card(corpus, tmp_path):
    """Built or loaded without a device, an index goes to the card; on a
    machine without one that raises instead of quietly staying on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists here")
    from a_nice_rag_tpu.index.ivf import attach_ivf as jax_attach_ivf
    from a_nice_rag_tpu_torch.index import build_bm25_arrays
    from a_nice_rag_tpu_torch.index import build_index as port_build_index
    from a_nice_rag_tpu_torch.index import save_index as port_save_index
    from a_nice_rag_tpu_torch.index.convert import from_reference_ivf
    from a_nice_rag_tpu_torch.index.ivf import load_ivf, save_ivf

    jidx = _jax_index(corpus)
    jax_attach_ivf(jidx, MODELS[0], n_clusters=4, tile_n=128)
    tidx = from_reference_index(jidx, device="cpu")
    port_save_index(tidx, str(tmp_path))
    save_ivf(tidx.ivf[MODELS[0]], str(tmp_path / "one.npz"))
    calls = {
        "build_index": lambda: port_build_index(
            ids=corpus.ids, sources=corpus.sources, contents=corpus.contents,
            embeddings=corpus.embeddings, token_lists=corpus.tokens),
        "build_bm25_arrays": lambda: build_bm25_arrays(corpus.tokens, 1280),
        "load_index": lambda: load_index(str(tmp_path)),
        "load_ivf": lambda: load_ivf(str(tmp_path / "one.npz")),
        "from_reference_index": lambda: from_reference_index(jidx),
        "from_reference_ivf": lambda: from_reference_ivf(jidx.ivf[MODELS[0]]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA GPU is required"):
            call()
            pytest.fail(f"{name} ran without a GPU")
    assert load_index(str(tmp_path), device="cpu").device.type == "cpu"
