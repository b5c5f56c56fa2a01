"""The port's native (C++) binary front: protocol, parity, coalescing.

Mirrors tests/test_native_front.py on the CPU: the front (a copy of
native/anr_serve.cpp, built with g++ into the port's _build/, and
serving/native_front.py) runs the loop client frame -> native queue ->
Python dispatch -> retrieve_device -> native reply, and its results must
equal a direct retriever call. Then the same frames go through the JAX
package's front and the port's: equal ids on the f32 and bf16 wires
(scores within 1e-6). Last, the client's bf16 rounding (torch integer
ops) against ml_dtypes' bits on 2^16 random floats and the special
values.
"""

import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest

from a_nice_rag_tpu.index import build_index as jax_build_index
from a_nice_rag_tpu.retrieval import FusedRetriever as JaxRetriever
from a_nice_rag_tpu.testing import synth_corpus
from a_nice_rag_tpu_torch.index import build_index
from a_nice_rag_tpu_torch.retrieval import FusedRetriever
from a_nice_rag_tpu_torch.serving.native_front import (
    NativeFrontClient,
    NativeRetrievalFront,
    bf16_bits,
    bf16_values,
)

MODEL = "voyage-3-large"
WEIGHTS = {MODEL: 5.0, "BM25": 1.0}
SCORE_ATOL = 1e-6


def _args(c):
    return dict(ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens)


@pytest.fixture(scope="module")
def setup():
    c = synth_corpus(n_docs=300, dim=32, n_queries=64, seed=17)
    idx = build_index(device="cpu", **_args(c))
    fr = FusedRetriever(idx, (MODEL,), use_bm25=True, similarity_k=10,
                        common_sections_n=5, budget=4096)
    return c, idx, fr


def _front(fr, **kw):
    kw.setdefault("t_max", 16)
    kw.setdefault("wait_ms", 5.0)
    return NativeRetrievalFront(fr, WEIGHTS, port=0, **kw)


def _direct(fr, q, terms):
    d_rows, d_scores, _ = fr.retrieve_device({MODEL: q}, terms, WEIGHTS,
                                             None, 40.0)
    return d_rows.numpy(), d_scores.numpy()


def _client(front, **kw):
    return NativeFrontClient("127.0.0.1", front.port, timeout_s=30, **kw)


def _batch(c, idx, b):
    return (np.asarray(c.query_embeddings[MODEL][:b], np.float32),
            np.asarray(idx.pad_term_ids(c.query_tokens[:b], 16), np.int32))


def test_native_front_matches_direct_call(setup):
    c, idx, fr = setup
    q, terms = _batch(c, idx, 8)
    with _front(fr) as front:
        with _client(front) as cl:
            rows, scores = cl.search(q, terms)
    d_rows, d_scores = _direct(fr, q, terms)
    np.testing.assert_array_equal(rows, d_rows)
    np.testing.assert_allclose(scores, d_scores, rtol=1e-6)


def test_native_front_single_row_and_no_terms(setup):
    c, idx, fr = setup
    q = np.asarray(c.query_embeddings[MODEL][0], np.float32)
    with _front(fr) as front:
        with _client(front) as cl:
            rows, _ = cl.search(q)  # 1-row frame, no terms
            assert rows.shape[0] == 1
            # Terms pad to -1 server-side: BM25 contributes nothing.
            assert c.gold_ids[0] in [idx.meta.ids[j] for j in rows[0]
                                     if j >= 0]


def test_native_front_coalesces_concurrent_clients(setup):
    c, idx, fr = setup
    n_clients, per = 4, 4
    results, errors = {}, []
    with _front(fr, wait_ms=20.0) as front:
        barrier = threading.Barrier(n_clients, timeout=30)

        def worker(w):
            try:
                with _client(front) as cl:
                    barrier.wait()
                    for j in range(per):
                        i = w * per + j
                        t = idx.pad_term_ids([c.query_tokens[i]], 16)[0]
                        results[i] = cl.search(
                            np.asarray(c.query_embeddings[MODEL][i],
                                       np.float32),
                            np.asarray(t, np.int32))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stats = front.stats()
    assert not errors, errors
    assert len(results) == n_clients * per
    assert stats["rows_in"] == n_clients * per
    assert stats["bad_frames"] == 0
    # Concurrent 1-row frames coalesce into shared device batches.
    assert stats["batches_run"] < n_clients * per
    hits = sum(c.gold_ids[i] in [idx.meta.ids[j] for j in rows[0] if j >= 0]
               for i, (rows, _) in results.items())
    assert hits >= n_clients * per - 2


def test_native_front_rejects_garbage_then_keeps_serving(setup):
    c, idx, fr = setup
    with _front(fr) as front:
        s = socket.create_connection(("127.0.0.1", front.port), timeout=5)
        s.sendall(b"GET / HTTP/1.1\r\n\r\n")
        # Dropped on protocol desync: a clean FIN or an RST.
        try:
            assert s.recv(64) == b""
        except ConnectionResetError:
            pass
        s.close()
        q = np.asarray(c.query_embeddings[MODEL][:2], np.float32)
        with _client(front) as cl:
            rows, _ = cl.search(q)
            assert rows.shape[0] == 2
        assert front.stats()["bad_frames"] >= 1


def test_native_front_multi_model_rejected(setup):
    c, idx, fr = setup

    class Fake:
        model_names = ("a", "b")
        index = idx

    with pytest.raises(ValueError, match="single-dense-model"):
        NativeRetrievalFront(Fake(), WEIGHTS, port=0)


def test_native_front_hostname_binds(setup):
    """--host localhost (a hostname, not an IPv4 literal) binds."""
    c, idx, fr = setup
    q = np.asarray(c.query_embeddings[MODEL][:2], np.float32)
    with _front(fr, host="localhost") as front:
        with NativeFrontClient("localhost", front.port, timeout_s=30) as cl:
            rows, _ = cl.search(q)
            assert rows.shape[0] == 2


def test_native_front_quantized_index(setup):
    """An int8 index keeps its model in dense_q: the front takes the depth
    from dense_matrix()'s QuantizedDense."""
    c, _, _ = setup
    q_idx = build_index(quantize_dense=True, device="cpu", **_args(c))
    assert MODEL not in q_idx.dense
    qfr = FusedRetriever(q_idx, (MODEL,), use_bm25=True, similarity_k=10,
                         common_sections_n=5, budget=4096)
    q, terms = _batch(c, q_idx, 4)
    with _front(qfr) as front:
        assert front.dim == q.shape[1]
        with _client(front) as cl:
            rows, scores = cl.search(q, terms)
    d_rows, d_scores = _direct(qfr, q, terms)
    np.testing.assert_array_equal(rows, d_rows)
    np.testing.assert_allclose(scores, d_scores, rtol=1e-6)


def test_native_front_sharded_retriever(setup):
    """A ShardedRetriever (2 x 4 "cpu" slots): the depth comes from the
    shards and batches pad to a dp multiple."""
    from a_nice_rag_tpu_torch.parallel import (
        ShardedRetriever,
        make_mesh,
        shard_index,
    )

    c, idx, fr = setup
    sidx = shard_index(idx, make_mesh(shape=(2, 4), devices=["cpu"] * 8))
    sr = ShardedRetriever(sidx, (MODEL,), use_bm25=True, similarity_k=10,
                          common_sections_n=5, budget=4096)
    q, terms = _batch(c, idx, 8)
    with _front(sr) as front:
        assert front.dim == q.shape[1]
        assert front._bucket(3) == 4 and front._bucket(1) == 2
        with _client(front) as cl:
            rows, scores = cl.search(q, terms)
            odd, _ = cl.search(q[:3], terms[:3])
    d_rows, d_scores = _direct(sr, q, terms)
    np.testing.assert_array_equal(rows, d_rows)
    np.testing.assert_allclose(scores, d_scores, rtol=1e-6)
    np.testing.assert_array_equal(odd, d_rows[:3])


def test_native_front_backpressure_cap(setup):
    """With a tiny max_queued_rows, a client pipelining frames far ahead
    of the device hits reader backpressure but gets every reply (req_id
    pairs them)."""
    c, idx, fr = setup
    n_frames = 24
    q = np.asarray(c.query_embeddings[MODEL][0], np.float32)
    with _front(fr, max_queued_rows=4, wait_ms=5.0) as front:
        s = socket.create_connection(("127.0.0.1", front.port), timeout=30)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        body = q.tobytes()
        blob = b"".join(
            struct.pack("<IIIHH", 0x51524E41, 8 + len(body), rid, 1, 0)
            + body for rid in range(1, n_frames + 1))
        sender = threading.Thread(target=s.sendall, args=(blob,),
                                  daemon=True)
        sender.start()

        def recv_all(n):
            out = b""
            while len(out) < n:
                b = s.recv(n - len(out))
                assert b, "connection closed early"
                out += b
            return out

        got = []
        for _ in range(n_frames):
            magic, plen = struct.unpack("<II", recv_all(8))
            assert magic == 0x50524E41
            got.append(struct.unpack("<I", recv_all(plen)[:4])[0])
        sender.join(timeout=30)
        s.close()
        assert sorted(got) == list(range(1, n_frames + 1))


def test_native_front_bf16_wire(setup):
    """wire_dtype="bf16": the rows are the bf16-rounded query's, so the
    ids equal a direct call on those rows, and overlap the f32 query's."""
    c, idx, fr = setup
    q, terms = _batch(c, idx, 8)
    with _front(fr, wire_dtype="bf16") as front:
        assert front.wire_dtype == "bf16"
        with _client(front, wire_dtype="bf16") as cl:
            rows, scores = cl.search(q, terms)
            # Rows already rounded, given as their bits, go as they are.
            bits_rows, _ = cl.search(bf16_bits(q), terms)
    np.testing.assert_array_equal(bits_rows, rows)
    d_rows, d_scores = _direct(fr, bf16_values(bf16_bits(q)), terms)
    np.testing.assert_array_equal(rows, d_rows)
    np.testing.assert_allclose(scores, d_scores, rtol=1e-6)
    f_rows, _ = _direct(fr, q, terms)
    k = rows.shape[1]
    overlap = np.mean([len(set(rows[i]) & set(f_rows[i])) / k
                       for i in range(8)])
    assert overlap >= 0.9, f"bf16-wire overlap {overlap} vs f32 direct"
    hits = sum(c.gold_ids[i] in [idx.meta.ids[j] for j in rows[i] if j >= 0]
               for i in range(8))
    assert hits >= 7


def test_native_front_wire_dtype_mismatch(setup):
    """A frame of the wrong dtype gets an error naming the expected one."""
    c, idx, fr = setup
    q = np.asarray(c.query_embeddings[MODEL][:2], np.float32)
    with _front(fr, wire_dtype="bf16") as front:
        with _client(front) as cl:  # f32
            with pytest.raises(RuntimeError, match="expects bf16"):
                cl.search(q)
    with _front(fr) as front:  # f32 server
        with _client(front, wire_dtype="bf16") as cl:
            with pytest.raises(RuntimeError, match="expects f32"):
                cl.search(q)


def test_native_front_int8_wire(setup):
    """wire_dtype="int8": int8 rows + per-row f32 scale, dequantized on
    the device. Ranking overlaps the f32 path's, and a round-exact query
    (already i8 * scale) reproduces the f32 path's ids."""
    c, idx, fr = setup
    q, terms = _batch(c, idx, 8)
    mx = np.max(np.abs(q), axis=1, keepdims=True)
    q_exact = (np.clip(np.rint(q / (mx / 127.0)), -127, 127)
               * (mx / 127.0)).astype(np.float32)
    with _front(fr, wire_dtype="int8") as front:
        assert front.wire_dtype == "int8"
        with _client(front, wire_dtype="int8") as cl:
            rows, _ = cl.search(q, terms)
            rows_e, _ = cl.search(q_exact, terms)
    d_rows, _ = _direct(fr, q, terms)
    k = rows.shape[1]
    overlap = np.mean([len(set(rows[i]) & set(d_rows[i])) / k
                       for i in range(8)])
    assert overlap >= 0.9, f"int8-wire overlap {overlap} vs f32 direct"
    hits = sum(c.gold_ids[i] in [idx.meta.ids[j] for j in rows[i] if j >= 0]
               for i in range(8))
    assert hits >= 7
    np.testing.assert_array_equal(rows_e, _direct(fr, q_exact, terms)[0])


def test_native_front_int8_wire_dtype_mismatch(setup):
    c, idx, fr = setup
    q = np.asarray(c.query_embeddings[MODEL][:2], np.float32)
    with _front(fr, wire_dtype="int8") as front:
        with _client(front) as cl:  # f32
            with pytest.raises(RuntimeError, match="expects int8"):
                cl.search(q)
    with _front(fr) as front:  # f32 server
        with _client(front, wire_dtype="int8") as cl:
            with pytest.raises(RuntimeError, match="expects f32"):
                cl.search(q)


# -- against the JAX package's front ----------------------------------------


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_native_front_parity_with_jax(setup, wire):
    from a_nice_rag_tpu.native.build import load_serve_lib as jax_lib
    from a_nice_rag_tpu.serving.native_front import (
        NativeFrontClient as JaxClient,
    )
    from a_nice_rag_tpu.serving.native_front import (
        NativeRetrievalFront as JaxFront,
    )

    assert jax_lib() is not None, "the JAX package's front did not build"
    c, idx, fr = setup
    jfr = JaxRetriever(jax_build_index(**_args(c)), (MODEL,), use_bm25=True,
                       similarity_k=10, common_sections_n=5, budget=4096)
    q, terms = _batch(c, idx, 16)
    with JaxFront(jfr, WEIGHTS, port=0, t_max=16,
                  wire_dtype=wire) as front:
        with JaxClient("127.0.0.1", front.port, timeout_s=60,
                       wire_dtype=wire) as cl:
            j_rows, j_scores = cl.search(q, terms)
    with _front(fr, wire_dtype=wire) as front:
        with _client(front, wire_dtype=wire) as cl:
            t_rows, t_scores = cl.search(q, terms)
    np.testing.assert_array_equal(t_rows, j_rows)
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=SCORE_ATOL)


def test_bf16_rounding_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    with np.errstate(over="ignore", invalid="ignore"):
        x = (rng.standard_normal(1 << 16)
             * 10.0 ** rng.integers(-40, 39, 1 << 16)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                        3.4028235e38, -3.4028235e38, 1e-45, -1e-45,
                        1.1754942e-38, 1.00390625, 1.01171875, 1.0078125],
                       np.float32)
    bits = np.array([0x7F800001, 0xFF800001, 0x7FFFFFFF, 0x3F808000,
                     0x3F818000, 0x7F7FFFFF, 0x00008000, 0x80018000],
                    np.uint32).view(np.float32)
    x = np.concatenate([x, special, bits])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(bf16_bits(x), want)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(
        bf16_values(want)[finite],
        want.view(ml_dtypes.bfloat16).astype(np.float32)[finite])
