#!/usr/bin/env python3
"""Smoke run of the PyTorch port (a_nice_rag_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (one nvcc per source,
started together), holds each against its plain PyTorch version, then
drives the port's main path, ``FusedRetriever.retrieve_device``, at the
corpus sizes the repository was built for at scale, and the paths of the
port's bench (``a_nice_rag_tpu_torch.bench``) and stream probes:

  0. device check, card name and power limit, kernel build, the launch
     plans of the int8 and float top-k kernels and of the folds;
  1. K1 (fused_dense_top_k) against its plain version: f32 and bf16 rows,
     with and without a mask, N = 2^20 + 37, k in {1, 32, 128},
     B in {1, 7, 256}, duplicated rows (exact ties across doc splits),
     and k larger than the count of valid docs;
  2. K2 (fused_dense_top_k_int8) against its plain version, same cases,
     then the int8 path's edges at N_EDGE rows: D in {1, 33, 37, 1024},
     B at the query-block switch (8, 16, 17, 64, 65, 256), k in {1, 25,
     128}, rows and queries holding -128 and 127, exact ties across
     sub-tiles, tiles and CTAs, and rows whose base is not 16-byte aligned
     (values[1:] and a copy at an odd address), each torch.equal;
  3. K3/K4 (ivf_dense_top_k, ivf_dense_top_k_int8) against their plain
     versions on the same matrix in f32, bf16 and int8: tile_n 1024 and
     2048, a ragged last tile, static and dynamic (trailing-slot) row
     counts, -1 padded tables, k in {1, 16, 128, 256}, B in {1, 8, 256};
     then K4 on phase 2's edge rows (k up to 256), each torch.equal;
     then the float path's edges (K1 and K3, f32 and bf16 rows) at
     N_EDGE rows: D in {1, 33, 37, 1024, 2048} (the query block streamed
     by depth chunk at 2048 where it does not fit), B in {1, 8, 16, 17,
     64, 65, 256}, k up to 128 (K1) / 256 (K3), rows[1:] and rows at an
     address that is not 16-byte aligned, exact ties across sub-tiles,
     tiles and CTAs, masks that leave fewer than k candidates (tau =
     -inf) and unmasked cases (finite tau), each held through
     check_top_k at F32_ATOL / BF16_ATOL;
  4. stage A: 2^21 x 256 bf16 dense + CSR BM25 hybrid (bench.py's 2M
     configuration), planted recall and id equality with the torch route;
  5. stage B: the same index with a filter mask over half the docs and
     two-tier BM25 (128 common terms, so K1 runs masked twice per call);
 17. SearchEngine, the reference-parity API, on stage A's index (with
     ids, sources and a vocabulary): hybrid retrieve of B = 256 token
     queries (similarity_k 32, common_sections_n 15, weights 5:1,
     return_docs), planted recall@10 >= 0.99, no kernel launched (its
     routes are plain torch, as the JAX package's are plain XLA), its
     dense lists held against K1's through check_top_k at BF16_ATOL, and
     the host-clock ms of one retrieve beside the fused retriever's;
 18. the reference path, each part launching no kernel (plain torch
     routes, as in the JAX package): (1) the calibrated synthetic corpus
     of results/retrieval_evaluation_results_synthetic.csv (9,728 docs +
     4,096 hard distractors, four 256-wide models, 2,048 queries, the
     seed-42 85% partition of 1,741) indexed on the card and
     RetrievalEvaluator.run over the 7 configurations without rerank,
     each CSV row equal to that file's row to its 3 decimals, and the
     evaluator's dense scores held against a float64 product at 1e-5
     (no TF32); (2) the corpus written as reference-format artifacts
     (chunk DBs, BM25 pickle, query DBs, token CSV) and replayed by
     evals.replay_reference on the card and on the CPU, each card row
     within 1/n_q of the CPU's per metric, the artifact loaded twice
     through IndexManager (one object); (3) tune_bm25 with n_calls ==
     n_initial == 4 on the card, its history equal to the CPU's; (4)
     the evaluator on stage A's 2^21 x 256 bf16 index (ids, sources, a
     vocabulary of letter words, CSR BM25) at B = 256: dense-only,
     BM25-only and hybrid 5:1 (k = 12,000 lists, WRRF), hybrid recall@10
     >= 0.99, seconds and peak memory each; (5) RAGSystem on the same
     index: 16 queries streamed through query_rag_stream (hybrid 5:1,
     FakeLLMClient, per-model query embeddings), the stream tuple
     contract and the planted gold among each answer's sources_data,
     the median retrieval span, and one query under
     utils.trace.device_profile whose Chrome trace must hold CUDA kernel
     events;
 19. the sharded path (parallel/) on a virtual mesh of 4 corpus slots on
     the card, each part driven with the launch counts zeroed and read:
     (a) stage A's index through sharded_dense_top_k (ids equal to
     unsharded K1's, K1 once a shard) and ShardedRetriever (hybrid,
     recall@10 >= 0.99, its lists against FusedRetriever's through the
     exact rescoring, the torch route at B = 8, each shard's K1 list
     against its plain version), with the sharded, unsharded, K1 and
     merge times and a profile of the call (device ms, launches, idle
     share, host enqueue ms); (b) stage B's filter and two-tier streaming
     BM25 (K1 masked and on the common tier of each shard) against the
     unsharded two-tier route; (e) recovery: DeviceHealthMonitor with
     slot 2 dead, reshard_surviving over 3 slots, lists against the full
     mesh's, and a dp = 2 x corpus = 2 mesh serving an odd batch through
     ShardedSearchEngine with the dp = 1 mesh's ids; (f) 16 answers of
     RAGSystem over ShardedSearchEngine, the gold among each one's
     sources; (d) stage D's corpus with shard_ivf (per-shard k-means):
     64 calls at B = 8 through K3 per shard (recall@10 >= 0.90), a full
     probe equal to the exact route, save_shard_ivf / load_shard_ivf, the
     clustering loaded into the int8 copy of the corpus (K4 per shard),
     each shard's K3 / K4 list against its plain version; (c) stage C's
     int8 matrix as 4 views through K2 per shard against unsharded K2
     (recall@10 >= 0.95), each shard's list torch.equal to its plain
     version, and the sharded and unsharded times;
 20. the served path (serving/), each part driven with the launch counts
     zeroed and read, no part falling back: (a) stage A's index (ids,
     sources, a vocabulary; hybrid 5:1, k = 32, top 15) behind
     serve_cli.build_state with autotune (K1's plan tuned at the
     scheduler's widest batch, 512 rows, and held torch.equal to the
     default plan at B = 1, 8, 256 and 512, its ms beside the default's)
     and serve_state: the HTTP b64 RPC in f32 and bf16 and the native C++
     front's f32, bf16 and int8 wires, each 8 clients x 5 rounds x 5
     requests of 256-row frames, every f32 / bf16 reply's ids equal to a
     direct retrieve_device on its rows (bf16: on the bf16-rounded rows),
     every int8 reply's planted recall@10 >= 0.99 and its overlap@10 with
     the f32 wire; per front QPS min / median / max over the rounds, p50 /
     p99 request ms, the mean device batch and K1 at least once a device
     batch; one client in turn: 200 single-query JSON requests (B = 1) and
     200 8-row frames, their p50 / p99 and ids, each held to the served
     latency limit (p50 <= 10 ms, p99 <= 20 ms; PERF.md section 2), and
     the same rows through the scheduler pool and a direct
     retrieve_device, the layers below HTTP; (c)
     the same index over 4
     slots of the card (build_state(shards=4, devices=[cuda:0] * 4)),
     slot 3 killed through the monitor's probe, check_and_recover swapping
     the retriever and the pool live, the served fused ids before and
     after equal to the unsharded served ids, K1 4 then 3 a batch; (d)
     http_api.serve over RAGSystem on that index (FakeLLMClient,
     PrecomputedEmbedder): /v1/search, /v1/rag as JSON and as SSE with the
     planted gold among the sources for 16 queries, /v1/feedback, the UI
     page and /v1/embeddings; (b) stage D's corpus served dense-only in
     64 8-row frames, no coalescing (max_batch 8, max_wait_ms 0): the IVF
     route (nprobe 16, K3 once a frame, recall@10 >= 0.90) and the exact
     route (nprobe 0, K1), each list held against a direct call's by
     exact rescoring, the p50 / p99 of each; then the ``served`` line
     (each part's seconds and peak memory, the fronts, the latencies);
 21. the models (models/), each part driven with the launch counts zeroed
     and read: (a) Qwen3 at Qwen3-Embedding-0.6B's published widths
     (vocab 151,669, hidden 1024, 28 layers, 16 query / 8 kv heads of
     128, MLP 3072, rope_theta 1e6; seeded random weights in bf16, no TF32)
     embedding 64 rows of 128 ids with mixed lengths, left and right
     padding, last-token pooling: the forward's CUDA-event ms beside its
     bound (2 x non-embedding params x tokens at the bf16 peak), every
     row finite and of unit norm within 1e-3, 4 rows against the CPU's
     float32 forward of the same weights (cosine >= 0.99 each), a 2-layer
     cut float32 on the card against float32 on the CPU (max abs <=
     1e-4); then the 64 vectors through FusedRetriever.retrieve_device
     over a 2^20 x 1024 bf16 index with BM25 (K1 once, its plan at D =
     1024 printed; the dense list held against K1's plain version through
     check_top_k); (b) the served text path on stage A's index:
     build_state with OnDeviceEmbedder(EncoderConfig(out_dim=256)), as
     serve_cli --embedder hashing builds it, and serve_state; text
     /v1/search replies equal to a direct retrieve_device on the vector
     and terms encode_text_query gives, one client (text p50 / p99) and
     8 clients x 200 requests (served_qps_text min / median / max), the
     request's layers (embed, preprocess_text, the scheduler pool, HTTP),
     K1 at least once a device batch, and /v1/embeddings through
     http_api equal to embed_queries; (c) OnDeviceReranker with match
     features and NliScorer over 256 (query, document) pairs of
     synth_corpus: scores finite and within 2e-2 of the CPU's float32
     forward of the same weights, the rerank order equal wherever the
     CPU's gaps exceed it, ms a call and the forward's device ms; then the
     ``models`` line (each part's seconds, peak memory and K1 launches);
 22. generation (models/decoder.py, speculative.py, serving/genserver.py;
     no kernel is on this path: each part is driven with the launch
     counts zeroed and must launch none): (a) DecoderLM at Qwen3-0.6B's
     widths (vocab 151,936, 28 layers of 1024, 16 / 8 heads of 128, MLP
     3072, tied embeddings; seeded random bf16 weights), the prefill
     logits of 4 prompts of 64 ids against the CPU's float32 forward of
     the same weights, cosine >= 0.99 a row; (b) a 2-layer float32 cut
     of those weights, greedy streams on the card equal to the CPU's
     token for token: generate_stream at chunk 1 and 8, generate_batch,
     GenerationServer with wave, per-slot and chunked prefill and a
     retained prefix, the speculative stream (a 1-layer draft; equal to
     the target's stream too) and a json_object-constrained stream (its
     bytes a live JSON prefix), then sampled constrained requests on the
     card until one stops, which must json.loads; (c) the bench's gen
     stage at full width (bench.gen_stage: one stream at chunk 32 against
     64 requests x 160 tokens over 64 slots at chunk 16, ratio >= 2.5;
     TTFT p50; a steady tick's host ms, CUDA-event ms, busy ms, launches
     and idle share beside its bound; the 64-wide admission wave's peak
     memory); (d) serve_cli's local-LLM surface (build_local_llm_api,
     demo small_lm_config weights, JSON mode) on stage A's index through
     serve_state: /v1/generate as JSON and SSE (both equal to
     generate_text_stream on the server's model), /v1/chat/completions
     with response_format json_object (sampled requests until one stops,
     which must json.loads), a /v1/rag SSE answer from the local LLM, and
     the generate stream's TTFT and tokens/s; then the ``generation``
     line;
 23. tensor-parallel generation and training (parallel/lm.py,
     models/train.py, trainer.py, checkpoint.py, rerank_train.py, nli.py,
     pipeline.py, moe.py), each part a path of its own: (a), (b), (d)
     and (e) launch no kernel, (c) serves through K1. (a) phase 22's
     decoder over tp = 2 and 4 slots of the card: the prefill logits
     against phase 22 (a)'s CPU float32 logits, cosine >= 0.99 a row; on
     its float32 cut, the greedy streams of the staggered wave,
     speculative decoding and chunked prefill over a cached prefix equal
     to the one-slot server's on the card; tok/s at 64 slots, chunk 16,
     tp = 1 and 2; (b) train_encoder at EncoderConfig's defaults (the
     served hashing encoder: vocab 32,768, 4 layers x 256, 4 heads, out
     256) on 3,840 seeded query/document pairs, 256 x 128 tokens a batch,
     60 steps, a checkpoint every 20, then one more epoch resumed from
     the last: the loss falls, recall@1 on the held-out pairs rises, the
     first step's loss and parameters on the card (float32) equal to the
     CPU's float32 step on 64 rows, step ms, tokens/s and peak memory;
     (c) that checkpoint served as serve_cli --embedder hashing
     --embedder-ckpt builds it over stage A's index: text replies equal
     to a direct embed + retrieve_device, K1 launched; (d) the reranker
     (2 x 256) trained on candidates mine_candidates takes from
     SearchEngine's hybrid lists over the calibrated corpus with hard
     distractors (holdout accuracy >= 0.85, tests/test_rerank_lift.py's
     floor) and the NLI scorer (2 x 256) on synth_nli_pairs (holdout AUC
     > 0.7, tests/test_nli_scorer.py's), each loss falling; (e) the
     parallel steps at EncoderConfig's defaults over 8 slots of the card:
     dp x tp 4 x 2, dp x tp x sp 2 x 2 x 2, dp x pp 2 x 4 (2 and 3
     microbatches) and dp x ep 2 x 4 (MoE, 4 experts): the first loss
     within 1e-2 of the one-slot step's (bf16), the loss falling over 4
     steps, each slot holding only its shards; then the ``training``
     line;
 24. the evaluation layer (evals/ragas, run_ragas_eval, question_gen; no
     kernel on it: each part launches none): (a) the guided local judge
     (LocalGuidedJudgeLLM, schema DFAs) over the small_lm_config decoder
     (float32, seeded) under a greedy GenerationServer on the card and
     on the CPU: evaluate(Faithfulness, ResponseRelevancy) over 4 seeded
     rows, every verdict, constraint name and score equal; (b) the judge
     at phase 22's widths (bf16, random weights) on a 16-slot server
     (prompts prefilled whole, one at a time) over stage A's index (each document given ~550
     bytes of text): generate_questions over 8 chunks and
     collect_rag_answers through LocalTpuLLMClient on that server (the
     text under plain-sentence constraints: the random vocabulary's ids
     past the bytes decode to nothing), score_rows with the guided judge
     (its budget the schemas' longest sentence, so every verdict stops
     and validates; no repair call) and EmbedderJudgeEmbeddings over the
     hashing embedder, write_results_csv; seconds, judge calls, tokens,
     tok/s, prompt tokens, peak memory; (c) FaithfulnesswithHHEM with an
     NLI scorer trained on the card over tests/test_judge_discrimination.
     py's corpus, its grounded and corrupted extractive responders over
     64 questions through RAGSystem: grounded >= 0.8, corrupted <= 0.3;
     then the ``evaluation`` line;
  6. stage D: 2^21 x 256 bf16 with a k-means IVF (bench.py's 2M IVF
     configuration): micro-batches of B = 8 through K3, B = 256 and a
     filtered call through K1, a full probe against the exact route, and
     the IVF/exact crossover record for B in {8, 16, 32, 64};
  7. stage C: 10.5M x 1024 int8 dense-only (bench.py's int8 configuration),
     and SearchEngine.similarity_search_batch there at B = 8 held against
     K2 through check_top_k at INT8_ATOL;
  8. stage E: stage C's matrix with a cluster-major IVF: micro-batches of
     B = 8 through K4, B = 256 through K2;
  9. the stream kernels (stream_sum, stream_sum_busy) against their plain
     versions: f32, bf16 and int8; 1, 2 and 8 parts; bias set and unset;
     a ragged row count, one row, and views that start mid-vector; an
     int8 case whose partial sums stay below 2^24, which must be exact;
     every launch shape of stream_sum, one launch a call and two calls
     the same bits; the busy kernel's per-CTA chains bit for bit;
 10. stage F: the bench's headline stage at full width (9,728 x 2048 f32,
     BM25 from tokens, B = 2048) through bench.headline_stage, with its
     recall guards and route parity (both routes are torch there: 9,728
     docs are below the kernel threshold);
 11. floor lines for stages A and C: bench.stream_floor (stream_sum) over
     the matrices those stages hold, against their retrieve_device time;
 12. the overlap probe (probes.dma_overlap) at X in {0, 8, 64};
 13. the anatomy of K1/K2 (probes.kernel_anatomy: the staging loops,
     + scoring, + the compare pass, + insertions and merge), each mode
     first held against its plain version at N_KERNEL on integer-valued
     rows (exact scores), then held again and timed on stage A's and
     stage C's matrices;
 14. the counted fold (probes.iteration_count) at N_KERNEL against its
     plain version (ids, values and every counter), then on stage A's
     and stage C's matrices with and without a subsample tau, again
     equal to its plain version there and its ids to K1's / K2's;
 15. the keys: xpack_keys / xpack_values over the 13 special values of
     the JAX package's key test plus 2^24 normals, bit for bit, and
     bf16_row_reduce (probes.bf16_fold) at [128, 8192] and [256, 16384],
     then on its edge cases (R 1-4096, W 1-65536, storage offsets, ties
     across a row's warps, all-equal rows, -inf and values below the mask,
     +-0.0, values that round to one bf16), torch.equal on all four
     outputs, one launch a call; its time at both shapes as an event
     pair around one call and device-only (50 calls between one pair);
 16. int4 (probes.int4): exact at 1024 x 256, B = 128, both unpacks;
     the folds' edges (D in {8, 40, 1000, 1024, 2048}, B from 1 to 256
     across clusters of 1-4 query blocks, N below one tile and ragged,
     -128/127 and -8/7, all-negative products, rows not 16-byte aligned),
     each torch.equal; then stage 2's folds over stage C's int8 matrix and
     a 5.4 GB packed one, all three kernels torch.equal to their plain
     versions there (both unpacks), and each fold's stream alone beside
     the whole fold.

Stages A-C also print the retrieve_device time of one call (CUDA
events, median of 10). Each kernel, its plain version and a one-call
PyTorch yardstick
(library_ms) are timed with CUDA events at the main path's shapes, and
each kernel's bound (the larger of its bytes over the HBM rate and its
operations over the peak rate of their type) is computed from the run's
inputs. Prints one JSON object per phase or timing line, the kernels
line, and, as the last line, {"ok": true, "device": {...}}. Any failed
check raises, so the exit code is nonzero and no result line is printed.
All data is made on the device from seeded torch.Generator streams,
except stage F's corpus, which is the bench's numpy synth_corpus.
"""

from __future__ import annotations

import collections.abc
import copy
import csv
import dataclasses
import itertools
import json
import logging
import os
import re
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
MODEL = "voyage-3-large"
K1_SOURCE = "a_nice_rag_tpu_torch/csrc/fused_topk.cu"
K3_SOURCE = "a_nice_rag_tpu_torch/csrc/ivf_topk.cu"
STREAM_SOURCE = "a_nice_rag_tpu_torch/csrc/stream_sum.cu"
ANATOMY_SOURCE = "a_nice_rag_tpu_torch/csrc/anatomy.cu"
KEYS_SOURCE = "a_nice_rag_tpu_torch/csrc/keys.cu"
INT4_SOURCE = "a_nice_rag_tpu_torch/csrc/int4.cu"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "fused_dense_top_k": (K1_SOURCE,
                          "a_nice_rag_tpu/ops/pallas/fused_topk.py:1440"),
    "fused_dense_top_k_int8": (K1_SOURCE,
                               "a_nice_rag_tpu/ops/pallas/fused_topk.py:1218"),
    "ivf_dense_top_k": (K3_SOURCE,
                        "a_nice_rag_tpu/ops/pallas/ivf_topk.py:143"),
    "ivf_dense_top_k_int8": (K3_SOURCE,
                             "a_nice_rag_tpu/ops/pallas/ivf_topk.py:174"),
    # P1 (and P2: scripts/probe_hbm_stream.py:67, :119, :168, :224).
    "stream_sum": (STREAM_SOURCE, "bench.py:226"),
    "stream_sum_busy": (STREAM_SOURCE, "scripts/probe_dma_overlap.py:74"),
    # P4 (its "stage", "score" and "compare" modes; "full" is K1/K2).
    "anatomy_top_k": (ANATOMY_SOURCE,
                      "scripts/profile_kernel_anatomy.py:138"),
    "anatomy_top_k_int8": (ANATOMY_SOURCE,
                           "scripts/profile_kernel_anatomy.py:138"),
    # P5.
    "fused_top_k_counted": (ANATOMY_SOURCE,
                            "scripts/probe_iteration_count.py:160"),
    "fused_top_k_counted_int8": (ANATOMY_SOURCE,
                                 "scripts/probe_iteration_count.py:160"),
    # T1: the key map and its inverse.
    "xpack_keys": (KEYS_SOURCE, "tests/test_pallas_fused.py:433"),
    "xpack_values": (KEYS_SOURCE, "tests/test_pallas_fused.py:433"),
    # P6 (the four kernels of :41, and :118).
    "bf16_row_reduce": (KEYS_SOURCE, "scripts/probe_bf16_fold.py:41"),
    # P7: stages 1 and 3 (:83, :243, :261), stage 2 (:167, :188).
    "int4_scores": (INT4_SOURCE, "scripts/probe_int4.py:83"),
    "int8_fold_max": (INT4_SOURCE, "scripts/probe_int4.py:167"),
    "int4_fold_max": (INT4_SOURCE, "scripts/probe_int4.py:188"),
}
F32_ATOL = 1e-5
BF16_ATOL = 1e-4
BM25_ATOL = 1e-4
FULL_PROBE_ATOL = 1e-4
# int8 scores across routes: K2 emits (acc * s_d) * s_q, the torch route
# (acc * s_q) * s_d; two float32 roundings of one exact product, at most
# a few ulps of scores below 2 in magnitude.
INT8_ATOL = 1e-6
# One H100 SXM (NVIDIA data sheet, dense rates): HBM bytes/s, FFMA f32
# FLOP/s (f32 rows score in IEEE f32, off the tensor cores), bf16
# tensor-core FLOP/s (bf16 rows: three MMAs per product, one for each
# bf16 piece of the f32 query), int8 tensor-core OP/s.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
INT8_OP_S = 1979e12
QUERY_PIECES = 3


# Phase 23 (d)'s NLI corpus: tests/test_nli_scorer.py's documents.
NLI_DOCS = [
    "Offer lifestyle advice to adults with hypertension. Blood pressure "
    "should be measured in both arms at diagnosis. Treatment with ACE "
    "inhibitors is recommended for adults under 55 years.",
    "Methotrexate is the first-line DMARD for rheumatoid arthritis. "
    "Folic acid supplementation reduces methotrexate toxicity. Monitor "
    "full blood count every 2 weeks until the dose is stable.",
    "Children with asthma should have a personalised action plan. "
    "Inhaled corticosteroids are the preferred preventer therapy. Review "
    "inhaler technique at every asthma consultation.",
    "Statins are recommended for the primary prevention of "
    "cardiovascular disease. Atorvastatin 20 mg is the usual starting "
    "dose. Liver function should be checked before starting treatment.",
    "Antibiotic prophylaxis is not routinely recommended for dental "
    "procedures. Amoxicillin remains the first choice for "
    "community-acquired pneumonia. Review antibiotic treatment after 48 "
    "hours of therapy.",
    "Screen all pregnant women for gestational diabetes risk factors. "
    "An oral glucose tolerance test is offered at 24 to 28 weeks. "
    "Metformin can be used when lifestyle changes are insufficient.",
]


def in_chunks(n: int, chunk: int) -> int:
    """``n`` decode steps in whole chunks."""
    return -(-n // chunk) * chunk


def longest_sentence(dfa) -> int:
    """Bytes in the longest sentence ``dfa`` accepts (a longest path from
    state 0 in its reachable, acyclic graph); raises where the language
    is unbounded."""
    nxt = np.asarray(dfa.next)
    succ = [np.unique(row[row >= 0]).tolist() for row in nxt]
    seen, todo = {0}, [0]
    while todo:
        for t in succ[todo.pop()]:
            if t not in seen:
                seen.add(t)
                todo.append(t)
    indeg = dict.fromkeys(seen, 0)
    for s in seen:
        for t in succ[s]:
            indeg[t] += 1
    order, ready = [], [s for s in seen if indeg[s] == 0]
    while ready:
        s = ready.pop()
        order.append(s)
        for t in succ[s]:
            indeg[t] -= 1
            if indeg[t] == 0:
                ready.append(t)
    if len(order) != len(seen):
        raise ValueError("the automaton accepts sentences of any length")
    best = {}
    for s in reversed(order):
        tails = [best[t] + 1 for t in succ[s] if best[t] >= 0]
        best[s] = max(tails + [0 if dfa.accept[s] else -1])
    return best[0]


class ChunkTexts(collections.abc.Sequence):
    """The text of every document of an index too large to hold them all
    as strings (2^21 of ~550 bytes): ``n_bytes`` of guideline-like
    sentences, made from the row on access."""

    WORDS = ("adults", "children", "hypertension", "asthma", "diabetes",
             "statins", "treatment", "review", "offer", "monitor", "dose",
             "therapy", "blood", "pressure", "risk", "lifestyle", "advice",
             "weeks", "daily", "first-line", "referral", "symptoms")

    def __init__(self, n: int, n_bytes: int):
        self.n, self.n_bytes = n, n_bytes

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, row: int) -> str:
        if not 0 <= row < self.n:
            raise IndexError(row)
        g = np.random.default_rng(row)
        words = [self.WORDS[i] for i in g.integers(0, len(self.WORDS),
                                                    self.n_bytes)]
        text, i = f"Section {row}.", 0
        while len(text) < self.n_bytes:
            text += f" Offer {words[i]} to {words[i + 1]} with " \
                    f"{words[i + 2]} {words[i + 3]}."
            i += 4
        return text[:self.n_bytes - 1] + "."


class Constrained:
    """A server seen through ``stream``, each request under one of its
    registered constraints: LocalTpuLLMClient's ``server=``."""

    def __init__(self, server, constraint: str):
        self.server, self.constraint = server, constraint

    def stream(self, ids, max_new_tokens):
        return self.server.stream(ids, max_new_tokens=max_new_tokens,
                                  constraint=self.constraint)


def sentenceify(tokens, n=9) -> str:
    """tests/test_judge_discrimination.py's document text: sentences of
    ``n`` tokens."""
    return " ".join(" ".join(tokens[i:i + n]) + "."
                    for i in range(0, len(tokens), n))


def statement_responder(prompt: str) -> str:
    """tests/test_judge_discrimination.py's statement extraction: the
    sentences of the answer in the prompt's trailing input."""
    tail = prompt.rsplit("Now process this input:", 1)[-1]
    m = re.search(r"Input: (\{.*\})\s*Output:\s*$", tail, re.S)
    data = json.loads(m.group(1)) if m else {}
    text = data.get("answer") or data.get("response") or ""
    sents = [s.strip() for s in re.split(r"(?<=\.)\s+", text)
             if len(s.strip()) > 12]
    return json.dumps({"statements": sents[:8] or [text[:80]]})


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def stage_a_word(v: int) -> str:
    """Stage A's BM25 term ``v`` as a word of query text: "zq" and one
    letter a-j per decimal digit. preprocess_text keeps such words as
    they are (no digit, no stopword, no plural suffix), so a query text
    built from them reaches BM25 with its terms intact."""
    return "zq" + "".join("abcdefghij"[int(d)] for d in str(v))


class _LogTimes(logging.Handler):
    """(time, message) of every log record while attached: the seconds of
    the replay's import and of each configuration come from the records
    the CLIs log at their stage boundaries."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record) -> None:
        self.records.append((record.created, record.getMessage()))

    def __enter__(self):
        root = logging.getLogger()
        self.root_level = root.level
        root.setLevel(logging.INFO)
        root.addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        root = logging.getLogger()
        root.removeHandler(self)
        root.setLevel(self.root_level)

    def config_seconds(self):
        """{configuration: seconds} from each "Evaluating: X" record to
        the "X: MRR=..." record that ends it."""
        starts, out = {}, {}
        for t, msg in self.records:
            if msg.startswith("Evaluating: "):
                starts[msg[len("Evaluating: "):]] = t
            else:
                for name, t0 in starts.items():
                    if msg.startswith(name + ": MRR="):
                        out[name] = t - t0
        return out

    def seconds_until(self, prefix, t0):
        return next(t - t0 for t, msg in self.records
                    if msg.startswith(prefix))


def over_limits(latency, limits):
    """The (run, percentile, ms) of ``latency`` ({run: {"p50_ms": ...}})
    that exceed ``limits`` ({"p50_ms": ms, ...})."""
    return [(run, key, ms[key]) for run, ms in latency.items()
            for key, limit in limits.items() if ms[key] > limit]


def _equal_ids(got, want, what) -> None:
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: a reply's ids differ from a direct "
                             "retrieve_device on its rows")


class Smoke:
    # Sizes of the phases (bench.py's configurations for stages A-E).
    N_KERNEL, D_KERNEL = (1 << 20) + 37, 256
    # The int8 path's edge cases: rows, depths, batches at the query-block
    # switch, k, the IVF tile.
    N_EDGE, EDGE_D = 70_001, (1, 33, 37, 1024)
    EDGE_B, EDGE_K, EDGE_TILE = (8, 16, 17, 64, 65, 256), (1, 25, 128), 1024
    # The float path's edges (K1, K3): depths, batches, k cycled per case.
    EDGE_FLOAT_D = (1, 33, 37, 1024, 2048)
    EDGE_FLOAT_B = (1, 8, 16, 17, 64, 65, 256)
    EDGE_FLOAT_K = (1, 16, 25, 128)
    IVF_TILES = (1024, 2048)
    N_A, D_A, B, T, V, DF = 1 << 21, 256, 256, 16, 1 << 17, 16
    N_C, D_C, CLUSTERS, CHUNKS = 10_485_760, 1024, 4096, 40
    V_COMMON = 128
    # Stage D: 2048 planted centres, k-means IVF, nprobe 16, k 16.
    N_D, D_D, CENTRES_D, TILE_D, NPROBE_D, K_D, V_D = (
        1 << 21, 256, 2048, 1024, 16, 16, 1 << 17)
    BATCHES_D, B_MICRO = 64, 8
    CROSS_B = (8, 16, 32, 64)
    # Stage E: identity-permuted IVF over stage C, nprobe 8, k 25.
    TILE_E, NPROBE_E, K_E, BATCHES_E = 2048, 8, 25, 32
    # Stream cases: rows x columns of each part (no multiple of any
    # block), the int8 exact case, the busy kernel's chains and the
    # overlap probe's X.
    STREAM_ROWS, STREAM_D, EXACT_ROWS = 100_003, 64, 1 << 20
    STREAM_CTAS = (1, 2, 4, 8)
    BUSY_X, OVERLAP_X = (0, 3), (0, 8, 64)
    # Probes: rows of int4 stage 2's packed matrix (stage C's count), the
    # bf16 fold's shapes, the normals of the key map's case.
    INT4_N = 10_485_760
    # P7's edges (probes.int4.check_edges): row counts, depths, batches.
    FOLD_EDGE_N, FOLD_EDGE_D = (100, 70_001), (8, 40, 1000, 1024, 2048)
    FOLD_EDGE_B = (1, 8, 16, 17, 64, 65, 129, 256)
    BF16_SHAPES = ((128, 8192), (256, 16384))
    BF16_EDGE_SHAPES = None  # None: probes.bf16_fold.EDGE_SHAPES
    # P6's event-pair time at [256, 16384], predicted before its redesign
    # was first timed on the card (ms, low and high).
    P6_PREDICTED_MS = (0.010, 0.020)
    KEY_NORMALS = 1 << 24
    # Phase 19: corpus slots of the virtual mesh on the card, each shard's
    # probed clusters (of ~sqrt(n_local) per shard), the odd batch served
    # over dp = 2.
    N_SLOTS, NPROBE_SHARDED, DP_ODD_B = 4, 16, 7
    # Stage F: bench.HeadlineConfig fields; empty = the bench's widths.
    HEADLINE = {}
    # Phase 18: the calibrated corpus of the synthetic sweep and its
    # distractors (scripts/run_synthetic_eval.py), the file whose rows
    # 1-7 the sweep must reproduce, the streamed RAG queries, the tuner's
    # calls, and the trace events counted in the profile (category).
    SWEEP = dict(n_docs=9728, dim=256, n_queries=2048, vocab_size=20000,
                 seed=42)
    SWEEP_DISTRACTORS = dict(n_per_gold=2, emb_cos=0.90, token_overlap=0.65)
    SWEEP_CSV = REPO / "results" / "retrieval_evaluation_results_synthetic.csv"
    RAG_QUERIES, TUNE_CALLS = 16, 4
    TRACE_EVENTS = "kernel"
    # Phase 20: clients of each front, rounds (QPS min / median / max over
    # them) and requests a client sends a round (8 x 5 x 5 = 200 requests
    # of B rows a front); requests of the one-client latency runs.
    SERVED_CLIENTS, SERVED_ROUNDS, SERVED_PER = 8, 5, 5
    SERVED_LATENCY = 200
    # The served latency limit of the one-client runs (B = 1 and B = 8 on
    # the 2m index, host clock; PERF.md section 2 says how it was set).
    SERVED_LIMITS_MS = {"p50_ms": 10.0, "p99_ms": 20.0}
    # Phase 21: Qwen3-Embedding-0.6B's widths (its published config.json;
    # random weights), the embedded batch (B sequences of S token ids),
    # the rows held against the CPU's float32 forward, the layers of the
    # float32 cut, the rows of the index its vectors query (K1's route),
    # and the (query, document) pairs of the reranker and the NLI scorer.
    QWEN3 = dict(vocab_size=151_669, hidden_size=1024, num_layers=28,
                 num_heads=16, num_kv_heads=8, head_dim=128,
                 intermediate_size=3072, rope_theta=1_000_000.0,
                 rms_eps=1e-6)
    QWEN3_B, QWEN3_S, QWEN3_CPU_ROWS, QWEN3_CUT = 64, 128, 4, 2
    N_MODELS, MODEL_PAIRS = 1 << 20, 256
    # Card against the CPU's float32 forward of the same weights: each
    # bf16 embedding's cosine, its norm, the float32 cut (max abs), and
    # the reranker's and the NLI scorer's scores (max abs).
    QWEN3_COS, UNIT_TOL, CUT_ATOL, PAIR_ATOL = 0.99, 1e-3, 1e-4, 2e-2
    # Phase 22: bench.GenConfig fields (empty = Qwen3-0.6B's widths, the
    # JAX bench's gen configuration), the parity prompts (count x ids), the
    # float32 cut's layers, its EOS id (Qwen's <|endoftext|>), the JSON
    # depth of its constrained stream (96 states x the vocab), the sampled
    # constrained requests tried for a parsing stop, and the cosine bound
    # of the bf16 logits against the CPU's float32 (phase 21's for Qwen3).
    GEN = {}
    GEN_PROMPTS, GEN_PROMPT_LEN, GEN_CUT, GEN_EOS = 4, 64, 2, 151_643
    GEN_JSON_DEPTH, GEN_JSON_TRIES, GEN_COS = 2, 16, 0.99
    # Phase 23: the tp degrees of the virtual mesh on the card; the tok/s
    # run's new tokens a request (64 requests over GEN's 64 slots, chunk
    # 16). The trainer: EncoderConfig fields (empty = its defaults, the
    # served encoder), the pairs, the batch (rows; the tokenizer's 128
    # tokens each), the epochs (3,840 / 256 x 4 = 60 steps), the checkpoint
    # and eval period, the pool of words the pairs share and the rows of
    # the card-vs-CPU first step. Its tolerances (float32 on both): the
    # first loss relative; a parameter within PARAM_ATOL except at most a
    # PARAM_SHARE of them, which AdamW's first step may move apart by up
    # to 2 x lr (m / sqrt(v) is the sign of a gradient, and a gradient
    # near zero may take either sign under two summation orders).
    TP_DEGREES, TP_NEW = (2, 4), 32
    TRAIN = {}
    TRAIN_PAIRS, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_EVERY = 3840, 256, 4, 20
    TRAIN_WORDS, TRAIN_CPU_ROWS = 300, 64
    TRAIN_LOSS_RTOL, PARAM_ATOL, PARAM_SHARE = 1e-4, 1e-5, 1e-3
    # The reranker's training queries over the calibrated corpus (its
    # sizes and floor: tests/test_rerank_lift.py's full tier), the NLI
    # scorer's pairs and epochs (tests/test_nli_scorer.py's) and floors.
    RERANK_CORPUS = dict(n_docs=1024, dim=128, n_queries=192,
                         vocab_size=6000, seed=42)
    RERANK_QUERIES, RERANK_EPOCHS, RERANK_FLOOR = 288, 2, 0.85
    NLI_PAIRS, NLI_EPOCHS, NLI_AUC_FLOOR = 256, 6, 0.7
    # The parallel steps: rows x tokens a batch, steps. Their first step
    # against the one-slot step's from the same weights (bf16 compute), by
    # the mesh's kind: the loss relative; each gradient's relative L2
    # error; the weights after it by phase (b)'s share-past-PARAM_ATOL
    # rule. tp / sp split matrix products, so their row-split partials are
    # rounded to bf16 once more; pp and ep run the one-slot arithmetic on
    # row blocks.
    PAR_BATCH, PAR_STEPS = 48, 4
    PAR_LOSS_RTOL = {"tp": 2e-3, "pp": 1e-5, "ep": 1e-5}
    PAR_GRAD_RTOL = {"tp": 5e-2, "pp": 5e-2, "ep": 5e-2}
    PAR_PARAM_SHARE = {"tp": 1e-2, "pp": 1e-2, "ep": 1e-2}
    # Phase 24: (a) seeded rows of the card-vs-CPU judge and its string
    # and list caps (NLIOut's longest sentence is then 402 bytes); (b) the
    # chunks questioned, each document's bytes (15 retrieved make the NLI
    # prompt ~9.5 KB), the server's slots and decode chunk, the
    # constrained question's and answer's longest, the judge's caps
    # (NLIOut's longest sentence is then 306 bytes);
    # (c) tests/test_judge_discrimination.py's corpus (64 questions), NLI
    # recipe and floors.
    EVAL_SAMPLES, EVAL_SMALL_CAPS = 4, (12, 2)
    EVAL_CHUNKS, EVAL_CHUNK_BYTES, EVAL_SLOTS = 8, 550, 16
    EVAL_DECODE_CHUNK = 8
    EVAL_QUESTION_CHARS, EVAL_ANSWER_CHARS, EVAL_CAPS = 40, 48, (8, 2)
    DISCRIM_CORPUS = dict(n_docs=384, dim=64, n_queries=64,
                          vocab_size=4000, seed=42)
    DISCRIM_ENCODER = dict(n_layers=2, dim=96, n_heads=4, max_len=256)
    DISCRIM_NLI = dict(n_pairs=512, seed=0, epochs=6, batch_size=32)
    DISCRIM_FLOORS = (0.8, 0.3)

    def __init__(self, port):
        self.p = port
        self.dev = port.require_cuda()
        self.b = port.bench  # data recipes and route checks shared with it
        self.card = self.b.card_line()
        self.gen = torch.Generator(device=self.dev)
        self.max_err = {name: 0.0 for name in KERNELS}
        self.swaps = {name: 0 for name in KERNELS}
        self.main_launches = {name: 0 for name in KERNELS}
        self.times = {}
        self.library = {}
        self.bounds = {}
        self.retrieve_ms = {}
        self.shard_seconds, self.sharded_parts = {}, {}
        self.served_parts, self.served_fronts = {}, {}
        self.served_latency_ms, self.served_layers_ms = {}, {}
        self.models_parts, self.models_k1 = {}, 0
        self.gen_parts = {}
        self.train_parts = {}
        self.eval_parts = {}
        self.t0 = time.perf_counter()
        self.timer = port.bench.Timer(
            device_ms=lambda fn, n: port.device_loop_ms(fn, n_loop=n,
                                                        trials=1),
            host_ms=lambda fn, n: port.chained_ms(fn, n=n, trials=1),
        )

    # -- helpers ----------------------------------------------------------

    def seed(self, s: int) -> torch.Generator:
        return self.gen.manual_seed(s)

    def compare(self, name, ref, got, atol) -> None:
        (rv, ri), (v, i) = ref, got
        torch.cuda.synchronize()
        self.swaps[name] += self.p.check_top_k(rv, ri, v, i, atol)
        both = torch.isfinite(rv) & torch.isfinite(v)
        if both.any():
            err = float((rv - v).abs()[both].max())
            self.max_err[name] = max(self.max_err[name], err)
        same = v[:, 1:] == v[:, :-1]
        valid = i[:, 1:] >= 0
        if not bool((i[:, 1:] > i[:, :-1])[same & valid].all()):
            raise AssertionError(f"{name}: an exact tie kept the higher id")

    def main_path(self, fn, probed=()):
        """Run ``fn`` with every launch count set to 0 just before and read
        just after: the counts of the port's main path alone. Launches of
        the kernels in ``probed`` (K1/K2 run by a probe of them) are
        returned but stay out of the kernels line, which counts the
        retrieval path's."""
        k = self.p.kernels
        torch.cuda.synchronize()
        k.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {name: getattr(k, name).launches for name in KERNELS}
        for name, n in got.items():
            if name not in probed:
                self.main_launches[name] += n
        return out, got

    @staticmethod
    def expect(stage, counts, at_least=False, **want) -> None:
        for name, n in want.items():
            if counts[name] < n if at_least else counts[name] != n:
                raise AssertionError(
                    f"{stage}: launches {counts}, expected {name} "
                    f"{'>=' if at_least else '='} {n}")

    def bound(self, name, n_bytes, ops, op_rate) -> None:
        """The least time the card could take: bytes over the HBM rate or
        operations over their peak rate, whichever is larger."""
        t_bytes = n_bytes / HBM_BYTES_S * 1e3
        t_ops = ops / op_rate * 1e3
        self.bounds[name] = (max(t_bytes, t_ops),
                             "bytes" if t_bytes >= t_ops else "operations")

    # -- phases -----------------------------------------------------------

    def phase0_build(self) -> None:
        print(self.card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        self.p.kernels.build_kernels()
        seconds = time.perf_counter() - t0
        for name in self.p.kernels.SOURCES:
            report = self.p.build_log.get(name, (seconds, ""))[1]
            entry = ""
            for line in report.splitlines():
                found = re.search(r"entry function '(\w+)'", line)
                if found:
                    entry = found.group(1)
                elif "registers" in line or "spill" in line:
                    print(f"ptxas {name} {entry}:", line.strip(), flush=True)
        log(phase="build", seconds=round(seconds, 3),
            sources=list(self.p.kernels.SOURCES),
            torch=torch.__version__, cuda=torch.version.cuda)
        self.int8_plan_line()
        self.fold_plan_line()

    def int8_plan_line(self) -> None:
        """The int8 kernels' query block, dynamic shared memory (the
        source's sum, held against topk_plan's) and CTAs per SM at the
        main path's shapes."""
        plan = self.p.topk_plan
        shapes = []
        for b, d, kk in ((self.B, self.D_C, 25), (self.B_MICRO, self.D_C, 25),
                         (self.B_MICRO, self.D_C, 256)):
            bq = plan.query_block(b, d, kk)
            smem = self.p.int8_smem_bytes(bq, d, kk)
            if smem != plan.smem_bytes(bq, d, kk):
                raise AssertionError(f"int8 shared memory {smem} != the "
                                     f"plan's {plan.smem_bytes(bq, d, kk)}")
            shapes.append({"b": b, "d": d, "k": kk, "bq": bq,
                           "smem_bytes": smem,
                           "ctas_per_sm": plan.ctas_per_sm(bq, d, kk)})
        log(phase="int8_plan", shapes=shapes)
        self.float_plan_line()

    def float_plan_line(self) -> None:
        """The float kernels' (K1, K3) query block, whether it stays
        resident in shared memory, the source's shared-memory sum held
        against topk_plan's, CTAs per SM, and the splits of the main and
        tau passes, at the main path's shapes and the edges' deepest."""
        plan, sms = self.p.topk_plan, self.p.sm_count(self.dev)
        shapes = []
        for b, d, kk, rows in (
                (self.B, self.D_A, 32, "bfloat16"),
                (self.B_MICRO, self.D_D, self.K_D, "bfloat16"),
                (self.B, self.V_COMMON, 32, "float32"),
                (self.B, self.EDGE_FLOAT_D[-1], 128, "bfloat16"),
                (self.B_MICRO, self.EDGE_FLOAT_D[-1], 256, "float32")):
            bq = plan.query_block(b, d, kk, rows)
            qres = plan.resident(bq, d, kk, rows)
            smem = self.p.float_smem_bytes(bq, d, kk, rows, qres)
            want = plan.smem_bytes(bq, d, kk, rows, qres)
            if smem != want:
                raise AssertionError(f"float shared memory {smem} != the "
                                     f"plan's {want}")
            fused = plan.fused_plan(self.N_A, b, d, kk, sms, rows)
            shapes.append({
                "b": b, "d": d, "k": kk, "rows": rows, "bq": bq,
                "resident": qres, "smem_bytes": smem,
                "ctas_per_sm": plan.ctas_per_sm(bq, d, kk, rows),
                "k1_splits_2m": fused.splits,
                "k1_tau_splits_2m": plan.tau_fused_plan(
                    self.N_A, b, d, kk, sms, rows)[0]})
        log(phase="float_plan", shapes=shapes)

    def fold_plan_line(self) -> None:
        """P7's launch (fold_plan: clusters of query blocks, TMA or the
        producer's loads, ring slots, shared memory held against the
        source's sum) at the main path's shapes and the edges' deepest."""
        i4, sms = self.p.int4_kernels, self.p.sm_count(self.dev)
        index = self.dev.index if self.dev.index is not None else 0
        shapes = []
        for n, b, d, packed in (
                (self.N_C, self.B, self.D_C, False),
                (self.INT4_N, self.B, self.D_C, True),
                (1024, 128, 256, True),
                (self.N_EDGE, 256, 2048, False),
                (self.N_EDGE, 8, 1000, False)):
            plan = i4.fold_plan(n, b, d, packed, sms)
            active = self.p.fold_active_clusters(index, plan.cluster,
                                                 plan.smem_bytes)
            plan = i4.fold_plan(n, b, d, packed, sms, True, active)
            src = self.p.fold_smem_bytes(d, packed, plan.stages,
                                         plan.resident)
            if src != plan.smem_bytes:
                raise AssertionError(f"fold shared memory {src} != the "
                                     f"plan's {plan.smem_bytes}")
            shapes.append({"n": n, "b": b, "d": d, "packed": packed,
                           "active_clusters": active, "grid": plan.grid,
                           **plan._asdict()})
        log(phase="fold_plan", shapes=shapes)

    def kernel_cases(self, n, d, dtype):
        g = self.seed(101)
        emb = self.b.unit(torch.randn((n, d), generator=g, device=self.dev))
        # Exact ties across doc splits: the first rows again further on.
        for start in (n // 3, n // 2, n - 300):
            emb[start:start + 256] = emb[:256]
        q = self.b.unit(torch.randn((self.B, d), generator=g, device=self.dev))
        half = torch.rand(n, generator=g, device=self.dev) < 0.5
        few = torch.zeros(n, dtype=torch.bool, device=self.dev)
        few[torch.randint(0, n, (5,), generator=g, device=self.dev)] = True
        return emb.to(dtype), q, half, few

    def phase1_k1(self) -> None:
        k = self.p.kernels
        n, d = self.N_KERNEL, self.D_KERNEL
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            emb, q, half, few = self.kernel_cases(n, d, dtype)
            cases = [(m, kk, b) for m in (None, half) for kk in (1, 32, 128)
                     for b in (1, 7, self.B)] + [(few, 32, 7)]
            for mask, kk, b in cases:
                got = k.fused_dense_top_k(emb, q[:b], kk, mask=mask)
                ref = k.fused_dense_top_k_torch(emb, q[:b], kk, mask=mask)
                self.compare("fused_dense_top_k", ref, got, atol)
                if mask is few:
                    assert int((got[1] >= 0).sum(dim=1).max()) <= 5
            del emb
        log(phase="k1_vs_plain", cases=2 * 19, ok=True,
            max_abs_err=self.max_err["fused_dense_top_k"],
            tie_swaps=self.swaps["fused_dense_top_k"])

    def phase2_k2(self) -> None:
        k = self.p.kernels
        n, d = self.N_KERNEL, self.D_KERNEL
        emb, q, half, few = self.kernel_cases(n, d, torch.float32)
        qd = self.p.quantize_embeddings(emb)
        del emb
        qv, qs = self.p.quantize_queries(q)
        cases = [(m, kk, b) for m in (None, half) for kk in (1, 32, 128)
                 for b in (1, 7, self.B)] + [(few, 32, 7)]
        for mask, kk, b in cases:
            args = (qd.values, qd.scales, qv[:b], qs[:b], kk)
            got = k.fused_dense_top_k_int8(*args, mask=mask)
            ref = k.fused_dense_top_k_int8_torch(*args, mask=mask)
            torch.cuda.synchronize()
            if not (torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])):
                raise AssertionError(f"K2 differs from its plain version "
                                     f"(k={kk}, B={b}, mask={mask is not None})")
            self.compare("fused_dense_top_k_int8", ref, got, 0.0)
        edges = 0
        for d in self.EDGE_D:
            values, scales, qv, qs, half = self.edge_rows(d)
            views = [(values, scales, f"D={d}"),
                     (values[1:], scales[1:], f"D={d}, values[1:]"),
                     (self.odd_address(values), scales,
                      f"D={d}, odd address")]
            for rows, scl, what in views:
                for b in self.EDGE_B:
                    for kk in self.EDGE_K:
                        mask = half[:rows.shape[0]] if kk == 25 else None
                        args = (rows, scl, qv[:b], qs[:b], kk)
                        self.equal_int8(
                            k.fused_dense_top_k_int8(*args, mask=mask),
                            k.fused_dense_top_k_int8_torch(*args, mask=mask),
                            f"K2, {what}, B={b}, k={kk}")
                        edges += 1
            del values, scales
        log(phase="k2_vs_plain", cases=len(cases), edge_cases=edges,
            edge_d=list(self.EDGE_D), edge_b=list(self.EDGE_B),
            edge_k=list(self.EDGE_K), ok=True,
            max_abs_err=self.max_err["fused_dense_top_k_int8"])

    @staticmethod
    def equal_int8(got, ref, what) -> None:
        """Values and ids equal. (The tie rule holds on the selection
        scores, before the query scale: two of them may round to one
        emitted value, so the emitted values' ties are not checked.)"""
        torch.cuda.synchronize()
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{what}: differs from the plain version")

    def odd_address(self, t):
        """A copy of t whose base is one element past a 16-byte boundary
        (one byte for int8 rows)."""
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=self.dev)
        view = buf[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 == t.element_size()
        return view

    def edge_rows(self, d):
        """N_EDGE int8 rows of depth d over the full range, 256 queries:
        rows 0-31 copies of queries 0-7 (each query's best rows), copied
        again across sub-tiles (64), a tile boundary (100) and far off
        (n // 2, n - 40: other CTAs), scales with them, so exact ties sit
        at the top of the lists; all-127 and all--128 rows and queries."""
        g = self.seed(171 + d)
        n, i8 = self.N_EDGE, dict(device=self.dev, dtype=torch.int8)
        values = torch.randint(-128, 128, (n, d), generator=g, **i8)
        qv = torch.randint(-128, 128, (256, d), generator=g, **i8)
        qv[8], qv[9] = 127, -128
        values[40], values[41] = 127, -128
        scales = torch.rand(n, generator=g, device=self.dev) + 0.5
        values[:32] = qv[torch.arange(32, device=self.dev) % 8]
        for start in (64, 100, n // 2, n - 40):
            values[start:start + 32] = values[:32]
            scales[start:start + 32] = scales[:32]
        qs = torch.rand(256, generator=g, device=self.dev) + 0.5
        half = torch.rand(n, generator=g, device=self.dev) < 0.5
        return values, scales, qv, qs, half

    def ivf_tables(self, n, tile_n):
        """Tile tables over a matrix of n real rows in tiles of tile_n:
        name -> (table, n_real argument). Real entries ascending first,
        then -1; the last tile holds n % tile_n real rows."""
        tiles = -(-n // tile_n)
        g = self.seed(103 + tile_n)
        pick = torch.randperm(tiles - 1, generator=g, device=self.dev)
        part = torch.cat([pick[: (2 * tiles) // 5].sort().values,
                          torch.tensor([tiles - 1], device=self.dev)])
        i32 = dict(dtype=torch.int32, device=self.dev)

        def padded(real, slots):
            out = torch.full((slots,), -1, **i32)
            out[: real.numel()] = real.to(torch.int32)
            return out

        partial = padded(part, part.numel() + tiles // 5)
        return {
            "full": (torch.arange(tiles, **i32), n),
            "partial": (partial, n),
            "dynamic": (torch.cat([partial, torch.tensor([n], **i32)]), 0),
            "last": (padded(torch.tensor([tiles - 1]), 3), n),
        }

    def phase3_ivf_kernels(self) -> None:
        """K3 and K4 against their plain versions: the N_KERNEL matrix in
        f32, bf16 and int8, padded to whole tiles with non-zero junk rows
        that only the n_real mask keeps out."""
        k = self.p.kernels
        n, d = self.N_KERNEL, self.D_KERNEL
        emb, q, _, _ = self.kernel_cases(n, d, torch.float32)
        qd = self.p.quantize_embeddings(emb)
        qv, qs = self.p.quantize_queries(q)
        cases = [("full", 16, 8), ("partial", 1, 1), ("partial", 128, 256),
                 ("dynamic", 256, 8), ("dynamic", 16, 256), ("last", 256, 256)]
        count = 0
        for tile_n in self.IVF_TILES:
            npad = -(-n // tile_n) * tile_n
            tables = self.ivf_tables(n, tile_n)
            for rows in ("float32", "bfloat16", "int8"):
                if rows == "int8":
                    vals = torch.cat([qd.values, qd.values[: npad - n]])
                    scl = torch.cat([qd.scales, qd.scales[: npad - n]])
                else:
                    e = torch.cat([emb, emb[: npad - n]]).to(
                        getattr(torch, rows))
                for name, kk, b in cases:
                    table, n_real = tables[name]
                    kw = dict(tile_n=tile_n, n_real=n_real)
                    if rows == "int8":
                        args = (vals, scl, qv[:b], qs[:b], table, kk)
                        got = k.ivf_dense_top_k_int8(*args, **kw)
                        ref = k.ivf_dense_top_k_int8_torch(*args, **kw)
                        torch.cuda.synchronize()
                        if not (torch.equal(got[0], ref[0])
                                and torch.equal(got[1], ref[1])):
                            raise AssertionError(
                                f"K4 differs from its plain version ({name}, "
                                f"tile_n={tile_n}, k={kk}, B={b})")
                        self.compare("ivf_dense_top_k_int8", ref, got, 0.0)
                    else:
                        got = k.ivf_dense_top_k(e, q[:b], table, kk, **kw)
                        ref = k.ivf_dense_top_k_torch(e, q[:b], table, kk,
                                                      **kw)
                        self.compare("ivf_dense_top_k", ref, got,
                                     F32_ATOL if rows == "float32"
                                     else BF16_ATOL)
                    ids = got[1][got[1] >= 0].long()
                    real = table[: table.numel() - (n_real == 0)]
                    if not (bool((ids < n).all()) and bool(
                            torch.isin(ids // tile_n, real).all())):
                        raise AssertionError(f"an id outside the tabled "
                                             f"real rows ({name})")
                    count += 1
            del tables
        edges = self.k4_edges()
        log(phase="k3_k4_vs_plain", cases=count, k4_edge_cases=edges,
            ok=True,
            max_abs_err_k3=self.max_err["ivf_dense_top_k"],
            tie_swaps_k3=self.swaps["ivf_dense_top_k"],
            max_abs_err_k4=self.max_err["ivf_dense_top_k_int8"])
        self.float_edges()

    def float_edge_rows(self, d, dtype):
        """N_EDGE unit rows of depth d and 256 unit queries: rows 0-31
        copies of queries 0-7 (each query's best rows), copied again
        across sub-tiles (64), a tile boundary (100) and far off (n // 2,
        n - 40: other CTAs), so exact ties sit at the top of the lists; a
        mask over half the rows and one that keeps every 997th row only
        (fewer than k candidates in tau's subsample: tau = -inf)."""
        g = self.seed(191 + d)
        n = self.N_EDGE
        emb = self.b.unit(torch.randn((n, d), generator=g, device=self.dev))
        q = self.b.unit(torch.randn((256, d), generator=g, device=self.dev))
        emb[:32] = q[torch.arange(32, device=self.dev) % 8]
        for start in (64, 100, n // 2, n - 40):
            emb[start:start + 32] = emb[:32]
        half = torch.rand(n, generator=g, device=self.dev) < 0.5
        few = torch.zeros(n, dtype=torch.bool, device=self.dev)
        few[::997] = True
        return emb.to(dtype), q, half, few

    def float_edges(self) -> None:
        """K1 and K3 at the float path's edges, f32 and bf16 rows, each
        through check_top_k (and the tie rule) at F32_ATOL / BF16_ATOL;
        counts the cases whose tau was finite and -inf."""
        k = self.p.kernels
        n, t = self.N_EDGE, self.EDGE_TILE
        npad = -(-n // t) * t
        tables = self.ivf_tables(n, t)
        cases, taus = {"k1": 0, "k3": 0}, {"finite": 0, "neg_inf": 0}
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            for d in self.EDGE_FLOAT_D:
                emb, q, half, few = self.float_edge_rows(d, dtype)
                views = ((emb, "as is"), (emb[1:], "rows[1:]"),
                         (self.odd_address(emb), "unaligned"))
                for rows, what in views:
                    m = rows.shape[0]
                    for i, b in enumerate(self.EDGE_FLOAT_B):
                        kk = self.EDGE_FLOAT_K[(i + d) % len(
                            self.EDGE_FLOAT_K)]
                        mask = (None, half[:m], few[:m])[i % 3]
                        tau = k.subsample_tau(rows, q[:b], kk, mask)
                        finite = bool(torch.isfinite(tau).all())
                        taus["finite" if finite else "neg_inf"] += 1
                        self.compare(
                            "fused_dense_top_k",
                            k.fused_dense_top_k_torch(rows, q[:b], kk, mask),
                            k.fused_dense_top_k(rows, q[:b], kk, mask), atol)
                        cases["k1"] += 1
                padded = torch.cat([emb, emb[: npad - n]])
                for rows in (padded, self.odd_address(padded)):
                    for name in ("full", "partial", "dynamic"):
                        table, n_real = tables[name]
                        for i, b in enumerate(self.EDGE_FLOAT_B):
                            kk = (1, 16, 128, 256)[(i + cases["k3"]) % 4]
                            kw = dict(tile_n=t, n_real=n_real)
                            self.compare(
                                "ivf_dense_top_k",
                                k.ivf_dense_top_k_torch(rows, q[:b], table,
                                                        kk, **kw),
                                k.ivf_dense_top_k(rows, q[:b], table, kk,
                                                  **kw), atol)
                            cases["k3"] += 1
                del emb, padded
        if not (taus["finite"] and taus["neg_inf"]):
            raise AssertionError(f"the edges missed a tau kind: {taus}")
        log(phase="float_edges_vs_plain", k1_cases=cases["k1"],
            k3_cases=cases["k3"], tau_cases=taus,
            edge_d=list(self.EDGE_FLOAT_D), edge_b=list(self.EDGE_FLOAT_B),
            ok=True, max_abs_err_k1=self.max_err["fused_dense_top_k"],
            max_abs_err_k3=self.max_err["ivf_dense_top_k"],
            tie_swaps_k1=self.swaps["fused_dense_top_k"],
            tie_swaps_k3=self.swaps["ivf_dense_top_k"])

    def k4_edges(self) -> int:
        """K4 on phase 2's edge rows: each depth, aligned and at an odd
        address, over the full, partial and dynamic tables of EDGE_TILE
        (a ragged last tile), every B of EDGE_B, k cycling through 1, 25,
        128 and 256."""
        k, t = self.p.kernels, self.EDGE_TILE
        n = self.N_EDGE
        npad = -(-n // t) * t
        tables = self.ivf_tables(n, t)
        ks = (1, 25, 128, 256)
        count = 0
        for d in self.EDGE_D:
            values, scales, qv, qs, _ = self.edge_rows(d)
            vals = torch.cat([values, values[: npad - n]])
            scl = torch.cat([scales, scales[: npad - n]])
            for rows, what in ((vals, "aligned"),
                               (self.odd_address(vals), "odd address")):
                for name in ("full", "partial", "dynamic"):
                    table, n_real = tables[name]
                    for b in self.EDGE_B:
                        kk = ks[count % len(ks)]
                        args = (rows, scl, qv[:b], qs[:b], table, kk)
                        kw = dict(tile_n=t, n_real=n_real)
                        self.equal_int8(
                            k.ivf_dense_top_k_int8(*args, **kw),
                            k.ivf_dense_top_k_int8_torch(*args, **kw),
                            f"K4, D={d}, {what}, {name}, B={b}, k={kk}")
                        count += 1
            del values, vals
        return count

    def stage_a_index(self):
        """bench.py's 2M configuration, built on the device."""
        return self.b.scale_2m_data(self.b.Scale2MConfig(
            n=self.N_A, dim=self.D_A, batch=self.B, t=self.T, vocab=self.V,
            df=self.DF), self.dev)

    def make_index(self, emb, bm25, n, sources=()):
        return self.b.array_index(n, dense={MODEL: emb}, bm25=bm25,
                                  df=self.DF, sources=sources)

    def phase4_stage_a(self):
        p = self.p
        emb, gold, q, bm25, terms = self.stage_a_index()
        n = emb.shape[0]
        index = self.make_index(emb, bm25, n)
        kw = dict(similarity_k=32, common_sections_n=32, budget=1024)
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=True, **kw)
        assert retr.use_kernel, "2M-doc config must route to the kernels"
        assert retr._two_tier is None
        qd = {MODEL: q}
        w_h = {MODEL: 5.0, "BM25": 1.0}

        runs, counts = self.main_path(lambda: [
            retr.retrieve_device(qd, terms, w, None, 40.0)
            for w in (w_h, {MODEL: 1.0, "BM25": 0.0},
                      {MODEL: 0.0, "BM25": 1.0})
        ])
        self.expect("stage A", counts, fused_dense_top_k=3)
        r_h, r_d, r_b = (self.b.recall_at_10(r[0], gold) for r in runs)
        assert r_h >= 0.99, f"2M hybrid recall@10 {r_h} below 0.99"
        assert r_d >= 0.95 and r_b >= 0.95, (r_d, r_b)

        ref_retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                    dense_backend="torch", **kw)
        assert not ref_retr.use_kernel
        ref = ref_retr.retrieve_device(qd, terms, w_h, None, 40.0)
        routes = self.b.assert_route_parity(
            runs[0], ref,
            [lambda ids: self.b.exact_dense(emb, q, ids),
             lambda ids: self.b.exact_bm25_uniform(bm25, terms, self.DF,
                                                   ids)],
            [F32_ATOL, BM25_ATOL],
        )
        self.retrieve_ms["A"] = p.cuda_event_ms(
            lambda: retr.retrieve_device(qd, terms, w_h, None, 40.0))
        log(stage="A_2M_hybrid", recall10_hybrid=r_h, recall10_dense=r_d,
            recall10_bm25=r_b, k1_launches=counts["fused_dense_top_k"],
            retrieve_ms=self.retrieve_ms["A"], **routes)
        del ref, ref_retr, runs
        return emb, gold, q, bm25, terms

    def phase5_stage_b(self, emb, q, bm25, terms):
        p = self.p
        n = emb.shape[0]
        sources = [("CG" if i % 2 == 0 else "NG") + str(i // 2)
                   for i in range(n)]
        index = self.make_index(emb, bm25, n, sources)
        kw = dict(similarity_k=32, common_sections_n=32, budget=1024)
        # A float32 common tier: bf16 would round the impacts by up to
        # 2^-9 relative, moving BM25 scores by ~1e-3, past the 1e-4 the
        # comparison with the CSR route holds.
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                two_tier_common=self.V_COMMON,
                                two_tier_dtype="float32", **kw)
        assert retr.use_kernel and retr._two_tier is not None
        assert retr._two_tier.v_common == self.V_COMMON
        # Half of each query's terms planted, half drawn from the common
        # tier, so the common-tier K1 call carries real counts.
        common = torch.nonzero(retr._two_tier.common_map[:-1] >= 0).flatten()
        g = self.seed(12)
        b = terms.shape[0]
        pick = torch.rand((b, common.numel()), generator=g,
                          device=self.dev).argsort(dim=1)[:, :8]
        terms_b = torch.cat([terms[:, :8],
                             common[pick].to(torch.int32)], dim=1)
        qd = {MODEL: q}
        w = {MODEL: 5.0, "BM25": 1.0}
        out, counts = self.main_path(
            lambda: retr.retrieve_device(qd, terms_b, w, "CG", 40.0))
        self.expect("stage B", counts, fused_dense_top_k=2)
        mask = index.filter_mask("CG")
        assert int(mask.sum()) == n // 2
        for ids in (out[0], out[2].reshape(-1, out[2].shape[-1])):
            live = ids[ids >= 0].long()
            assert bool(mask[live].all()), "an id outside the filter mask"
        ref_retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                    dense_backend="torch", **kw)
        ref = ref_retr.retrieve_device(qd, terms_b, w, "CG", 40.0)
        routes = self.b.assert_route_parity(
            out, ref,
            [lambda ids: self.b.exact_dense(emb, q, ids),
             lambda ids: self.b.exact_bm25_uniform(bm25, terms_b, self.DF,
                                                   ids)],
            [F32_ATOL, BM25_ATOL],
        )
        log(stage="B_2M_filtered_two_tier",
            k1_launches=counts["fused_dense_top_k"], masked_fraction=0.5,
            retrieve_ms=p.cuda_event_ms(
                lambda: retr.retrieve_device(qd, terms_b, w, "CG", 40.0)),
            **routes)
        return terms_b

    def phase17_search_engine(self, emb, gold, q, bm25, terms) -> None:
        """SearchEngine (the reference-parity API, plain torch routes, no
        kernel) on stage A's index with ids, sources and a vocabulary:
        hybrid retrieve with return_docs, its planted recall, its dense
        lists against K1's, and its host-clock time beside the fused
        retriever's on the same queries."""
        t0 = time.perf_counter()
        p = self.p
        n = emb.shape[0]
        ids = [str(i) for i in range(n)]
        meta = p.CorpusMeta(ids=ids, sources=["CG"] * n, contents=[""] * n,
                            urls=[], n_docs=n, n_docs_padded=n)
        vocab = {f"t{v}": v for v in range(bm25.vocab_size)}
        index = p.ArrayIndex(
            meta=meta, dense={MODEL: emb}, bm25=bm25, vocab=vocab,
            bm25_stats={"max_df": self.DF},
            bm25_doc_mask=np.ones(n, dtype=bool))
        tokens = [[f"t{v}" for v in row if v >= 0] for row in terms.tolist()]
        eng = p.SearchEngine(index)
        w = {MODEL: 5.0, "BM25": 1.0}
        kw = dict(query_token_lists=tokens, similarity_k=32,
                  common_sections_n=15, model_weights=w,
                  use_hybrid_search=True, return_docs=True)

        def retrieve():
            return eng.retrieve({MODEL: q}, **kw)

        docs, counts = self.main_path(retrieve)
        if any(counts.values()):
            raise AssertionError(f"SearchEngine launched kernels: {counts}")
        gold_ids = [str(g) for g in gold.tolist()]
        assert all(len(d) == 15 for d in docs), "15 docs per query"
        recall = sum(g in [d["id"] for d in ds[:10]]
                     for g, ds in zip(gold_ids, docs)) / len(gold_ids)
        assert recall >= 0.99, f"SearchEngine recall@10 {recall} below 0.99"
        vals, rows = eng.similarity_search_batch(q, MODEL, 32)
        kv, ki = p.kernels.fused_dense_top_k(emb, q, 32)
        torch.cuda.synchronize()
        swaps = p.check_top_k(kv, ki, vals, rows, BF16_ATOL)
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                similarity_k=32, common_sections_n=15)
        assert retr.use_kernel
        term_ids = torch.as_tensor(index.pad_term_ids(tokens, self.T),
                                   device=self.dev)
        host_ms = {
            "search_engine_retrieve": self.host_call_ms(retrieve),
            "fused_retrieve_device": self.host_call_ms(
                lambda: retr.retrieve_device({MODEL: q}, term_ids, w, None,
                                             60.0)),
        }
        log(stage="A_search_engine", batch=q.shape[0], similarity_k=32,
            common_sections_n=15, weights=[5, 1], recall10_planted=recall,
            kernel_launches=0, dense_lists_vs_k1_swaps=swaps,
            dense_lists_atol=BF16_ATOL, host_ms=host_ms, card=self.card,
            method="host clock around one call ending in a synchronize, "
            "median of 3 after a warm-up", seconds=time.perf_counter() - t0)
        del eng, index, retr

    @staticmethod
    def host_call_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return sorted(samples)[1]

    # -- phase 18: the reference path ---------------------------------------

    def no_kernels(self, what, fn):
        """``fn`` driven as a path of its own, with the launch counts set
        to 0 before and read after: the reference path runs plain torch
        routes, as the JAX package's run plain XLA."""
        out, counts = self.main_path(fn)
        if any(counts.values()):
            raise AssertionError(f"{what} launched kernels: {counts}")
        return out

    def phase18_reference_path(self, emb, gold, q, bm25, terms) -> None:
        t0 = time.perf_counter()
        c, split = self.sweep_corpus()
        self.reference_sweep(c, split)
        with tempfile.TemporaryDirectory() as tmp:
            fix = self.p.write_reference_fixture(str(Path(tmp) / "ref"), c)
            self.reference_replay(fix, tmp)
            self.reference_tune(c, split)
        del c
        torch.cuda.empty_cache()
        index, tokens = self.stage_a_reference_index(emb, bm25, terms)
        self.evaluator_at_scale(index, gold, q, tokens)
        self.rag_at_scale(index, gold, q, tokens)
        del index
        torch.cuda.empty_cache()
        log(phase="reference_path", seconds=time.perf_counter() - t0,
            card=self.card)

    def sweep_corpus(self):
        t0 = time.perf_counter()
        p = self.p
        c = p.add_hard_distractors(p.calibrated_quality_corpus(**self.SWEEP),
                                   **self.SWEEP_DISTRACTORS)
        split = p.seed42_split(len(c.gold_ids))
        log(reference="corpus", docs=len(c.ids), queries=len(c.gold_ids),
            evaluated=len(split[0]), models=list(c.embeddings),
            dim=self.SWEEP["dim"], seconds=time.perf_counter() - t0)
        return c, split

    def reference_sweep(self, c, split) -> None:
        """Step 1: the 7 configurations without rerank on the card, each
        row equal to the checked-in CSV's."""
        p = self.p
        t0 = time.perf_counter()
        index = p.build_index(ids=c.ids, sources=c.sources,
                              contents=c.contents, embeddings=c.embeddings,
                              token_lists=c.tokens, device=self.dev)
        build_s = time.perf_counter() - t0
        ev = p.RetrievalEvaluator(index)
        eval_idx = split[0]
        q_embs = {m: c.query_embeddings[m][eval_idx] for m in c.embeddings}
        gold = [c.gold_ids[i] for i in eval_idx]
        tokens = [c.query_tokens[i] for i in eval_idx]
        configs = [x for x in p.STANDARD_CONFIGURATIONS if not x.use_reranker]
        seconds, rows, found = {}, [], {}
        for cfg in configs:
            t1 = time.perf_counter()
            m = self.no_kernels(f"sweep {cfg.name}", lambda: (
                ev.evaluate_config(cfg, q_embs, gold,
                                   query_token_lists=tokens,
                                   filename_type_filter=None)))
            seconds[cfg.name] = time.perf_counter() - t1
            rows.append(p.metrics_csv_row(cfg.name, m))
            found[cfg.name] = m["found"]
        want = self.SWEEP_CSV.read_text().splitlines()[1:1 + len(configs)]
        assert len(want) == len(rows), want
        mean_rank_diffs = {}
        for got_row, want_row in zip(rows, want):
            g, w = got_row.split(","), want_row.split(",")
            # Every column to the file's decimals, but the mean rank over
            # found queries: BM25 totals of tied documents (a gold and its
            # distractors share length and terms) round by the summation
            # order of the product, so one query's rank may move by one
            # there, which moves the mean by 1/found.
            diff = abs(float(g[7]) - float(w[7]))
            if g[:7] + g[8:] != w[:7] + w[8:] or \
                    diff > 1.0 / found[g[0]] + 5e-4:
                raise AssertionError(
                    f"sweep row {got_row!r} != {self.SWEEP_CSV.name}'s "
                    f"{want_row!r}")
            if diff:
                mean_rank_diffs[g[0]] = round(diff, 3)
        # The evaluator's dense scores: IEEE float32 products, not TF32.
        model = next(iter(c.embeddings))
        got = ev._ranker_scores(model, q_embs[model][:256], None)
        exact = torch.as_tensor(q_embs[model][:256], dtype=torch.float64,
                                device=self.dev) @ torch.as_tensor(
            c.embeddings[model], dtype=torch.float64, device=self.dev).T
        err = float((got[:, :len(c.ids)].double() - exact).abs().max())
        if err > 1e-5:
            raise AssertionError(f"dense scores off a float64 product by "
                                 f"{err}: TF32?")
        log(reference="sweep", rows=rows, csv=str(self.SWEEP_CSV.name),
            rows_equal_csv=sum(a == b for a, b in zip(rows, want)),
            mean_rank_diffs=mean_rank_diffs, evaluated=len(gold),
            build_index_seconds=build_s, config_seconds=seconds,
            dense_vs_float64_max_err=err, card=self.card)
        del index, ev

    def replay(self, fix, tmp, device, out_name):
        argv = ["--workdir", str(Path(tmp) / out_name),
                "--output", str(Path(tmp) / f"{out_name}.csv"),
                "--bm25-pickle", fix.bm25_pickle,
                "--bm25-queries", fix.bm25_queries_csv,
                "--device", str(device)]
        for m, path in fix.chunk_dbs.items():
            argv += ["--chunk-db", f"{m}={path}"]
        for m, path in fix.query_dbs.items():
            argv += ["--queries-db", f"{m}={path}"]
        t0 = time.time()
        with _LogTimes() as times:
            self.no_kernels(f"replay on {device}",
                            lambda: self.p.replay_main(argv))
        with open(Path(tmp) / f"{out_name}.csv") as f:
            rows = list(csv.DictReader(f))
        return rows, times.seconds_until("stage 1:", t0), \
            times.config_seconds()

    def reference_replay(self, fix, tmp) -> None:
        """Step 2: the reference artifacts replayed on the card and on the
        CPU; the card's rows within 1/n_q of the CPU's."""
        rows, import_s, seconds = self.replay(fix, tmp, self.dev, "card")
        cpu_rows, cpu_import_s, cpu_seconds = self.replay(
            fix, tmp, "cpu", "cpu")
        n_q = len(self.p.seed42_split(self.SWEEP["n_queries"])[0])
        assert [r["Model"] for r in rows] == [r["Model"] for r in cpu_rows]
        assert len(rows) == 7, [r["Model"] for r in rows]
        worst = 0.0
        for got, want in zip(rows, cpu_rows):
            for key in ("MRR", "Recall@1", "Recall@5", "Recall@10",
                        "Recall@15"):
                diff = abs(float(got[key]) - float(want[key]))
                worst = max(worst, diff)
                # One query's rank moves a metric by <= 1/n_q, and each
                # 3-decimal rounding by half a unit of the last place.
                if diff > 1.0 / n_q + 1e-3:
                    raise AssertionError(f"replay {got} vs CPU {want}")
        artifact = str(Path(tmp) / "card" / "index")
        mgr = self.p.IndexManager(device=self.dev)
        t0 = time.perf_counter()
        first = mgr.load_artifact(artifact)
        load_s = time.perf_counter() - t0
        assert mgr.load_artifact(artifact) is first
        assert first.device.type == self.dev.type
        line = ",".join
        log(reference="replay", n_q=n_q, rows=[line(r.values()) for r in rows],
            rows_equal_cpu=sum(a == b for a, b in zip(rows, cpu_rows)),
            cpu_rows_differing=[line(b.values()) for a, b in
                                zip(rows, cpu_rows) if a != b],
            max_metric_diff_vs_cpu=worst, import_seconds=import_s,
            config_seconds=seconds, cpu_import_seconds=cpu_import_s,
            cpu_config_seconds=cpu_seconds, manager_load_seconds=load_s,
            manager_same_object=True, card=self.card)
        del first, mgr

    def reference_tune(self, c, split) -> None:
        """Step 3: tune_bm25's initial calls (no GP) on the card and on the
        CPU: equal histories."""
        rows = [{"id": c.ids[i], "tokens_regular": c.tokens[i],
                 "tokens_lemmatized": c.tokens[i]} for i in range(len(c.ids))]
        val = split[1]
        toks = [c.query_tokens[i] for i in val]
        qt = {"regular": toks, "lemmatized": toks}
        gold = [c.gold_ids[i] for i in val]
        kw = dict(n_calls=self.TUNE_CALLS, n_initial=self.TUNE_CALLS)
        t0 = time.perf_counter()
        got = self.no_kernels("tune_bm25", lambda: self.p.tune_bm25(
            rows, qt, gold, device=self.dev, **kw))
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = self.p.tune_bm25(rows, qt, gold, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        if got.history != want.history:
            raise AssertionError("tune_bm25 history on the card differs "
                                 "from the CPU's")
        log(reference="tune_bm25", calls=len(got.history),
            val_queries=len(gold), history_equal_cpu=True,
            best_params=got.best_params, best_recall15=got.best_score,
            seconds=card_s, cpu_seconds=cpu_s, card=self.card)

    def stage_a_reference_index(self, emb, bm25, terms):
        """Stage A's arrays with ids, sources and a vocabulary of words
        (stage_a_word), as a user's index would carry them."""
        p = self.p
        n = emb.shape[0]
        meta = p.CorpusMeta(ids=[str(i) for i in range(n)],
                            sources=["CG"] * n, contents=[""] * n, urls=[],
                            n_docs=n, n_docs_padded=n)
        words = [stage_a_word(v) for v in range(bm25.vocab_size)]
        index = p.ArrayIndex(
            meta=meta, dense={MODEL: emb}, bm25=bm25,
            vocab={w: v for v, w in enumerate(words)},
            bm25_stats={"max_df": self.DF},
            bm25_doc_mask=np.ones(n, dtype=bool))
        tokens = [[words[v] for v in row if v >= 0] for row in terms.tolist()]
        return index, tokens

    def evaluator_at_scale(self, index, gold, q, tokens) -> None:
        """Step 4: the evaluator at stage A's 2^21 docs, B = 256."""
        p = self.p
        ev = p.RetrievalEvaluator(index)
        gold_ids = [str(g) for g in gold.tolist()]
        names = ("Voyage-3-Large", "BM25", "Voyage-3-Large + BM25")
        out = {}
        for cfg in p.STANDARD_CONFIGURATIONS:
            if cfg.name not in names:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = self.no_kernels(f"evaluator {cfg.name}", lambda: (
                ev.evaluate_config(cfg, {MODEL: q}, gold_ids,
                                   query_token_lists=tokens,
                                   filename_type_filter=None)))
            torch.cuda.synchronize()
            out[cfg.name] = dict(
                seconds=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                mrr=m["mrr"], recall10=m["recall@10"],
                similarity_k=cfg.similarity_k)
        hybrid = out["Voyage-3-Large + BM25"]["recall10"]
        assert hybrid >= 0.99, f"evaluator hybrid recall@10 {hybrid} < 0.99"
        assert min(v["recall10"] for v in out.values()) >= 0.95, out
        log(reference="evaluator_stage_A", n=index.n_docs, batch=len(gold_ids),
            configs=out, card=self.card)

    def rag_at_scale(self, index, gold, q, tokens) -> None:
        """Step 5: RAGSystem over stage A's index, the answers streamed."""
        p = self.p
        system = p.RAGSystem(indexes={p.InfoSource.NICE: index},
                             llm_clients={"fake": p.FakeLLMClient()},
                             device=self.dev)
        w = {MODEL: 5.0, "BM25": 1.0}
        q_host = q.cpu().numpy()
        gold_ids = [str(g) for g in gold.tolist()]

        def ask(i):
            text = " ".join(tokens[i])
            if p.preprocess_text(text, use_lemmatization=True) != tokens[i]:
                raise AssertionError(f"query text {text!r} loses terms")
            return list(system.query_rag_stream(
                text, "fake-llm", model_weights=w, use_hybrid_search=True,
                use_reranker=False, filename_type_filter=None,
                query_embedding={MODEL: q_host[i]}))

        spans = []
        for i in range(self.RAG_QUERIES):
            out = self.no_kernels("query_rag_stream", lambda: ask(i))
            if len(out) < 2 or not all(
                    len(t) == 4 and isinstance(t[0], str)
                    and isinstance(t[1], str) and isinstance(t[2], str)
                    and isinstance(t[3], list) for t in out):
                raise AssertionError(f"stream tuples {out[:2]}")
            answer = "".join(t[0] for t in out)
            if not answer.startswith("[fake:fake-llm]"):
                raise AssertionError(f"answer {answer[:80]!r}")
            sections = [d["section_id"] for d in out[-1][3]]
            if gold_ids[i] not in sections:
                raise AssertionError(f"query {i}: gold {gold_ids[i]} not "
                                     f"among its sources {sections}")
            spans.append(system.last_trace.durations["retrieval"])
        with tempfile.TemporaryDirectory() as tmp:
            with p.device_profile(tmp) as prof:
                out = ask(self.RAG_QUERIES)
            with open(prof.trace_path) as f:
                events = json.load(f)["traceEvents"]
        n_events = sum(e.get("cat") == self.TRACE_EVENTS for e in events)
        if not n_events:
            raise AssertionError(f"no {self.TRACE_EVENTS!r} events in the "
                                 "profile of one query")
        log(reference="rag_stage_A", n=index.n_docs, queries=len(spans),
            gold_in_sources=len(spans), weights=[5, 1],
            retrieval_span_median_ms=statistics.median(spans) * 1e3,
            retrieval_span_ms=[s * 1e3 for s in spans],
            profiled_query_trace_events=len(events),
            profiled_query_kernel_events=n_events, card=self.card)
        del system

    def time_k1(self, emb, q) -> None:
        """K1 at stage A's shape: kernel, plain version, yardstick, bound."""
        k = self.p.kernels
        self.time_pair(
            "fused_dense_top_k",
            lambda: k.fused_dense_top_k(emb, q, 32),
            lambda: k.fused_dense_top_k_torch(emb, q, 32),
            "2^21 x 256 bf16, B=256, k=32, no mask",
        )
        self.time_library(
            "fused_dense_top_k",
            lambda: torch.topk(q @ emb.float().T, 32, dim=1),
            "torch.topk(q @ emb.float().T): upcast, f32 matmul, top-k",
        )
        (n, d), b = emb.shape, q.shape[0]
        self.bound("fused_dense_top_k", n * d * 2 + b * d * 4 + b * 32 * 8,
                   QUERY_PIECES * 2 * b * n * d, BF16_FLOP_S)
        log(timing="fused_dense_top_k_bound", bound_ms=self.bounds[
            "fused_dense_top_k"][0], ffma_bound_ms=2 * b * n * d / F32_FLOP_S
            * 1e3, what="bf16 MMA on three query pieces at 989 TFLOP/s; "
            "the same product on FFMA at 67 TFLOP/s beside it")
        got = k.fused_dense_top_k(emb, q, 32)
        self.compare("fused_dense_top_k",
                     k.fused_dense_top_k_torch(emb, q, 32), got, BF16_ATOL)

    def stage_d_index(self):
        """bench.py's 2M IVF configuration: 2048 planted unit centres,
        sigma = 0.08 doc noise, bf16; BATCHES_D x B_MICRO planted queries
        (gold + 0.05 noise) with planted BM25 terms."""
        n, d, c = self.N_D, self.D_D, self.CENTRES_D
        g = self.seed(41)
        cent = self.b.unit(torch.randn((c, d), generator=g, device=self.dev))
        which = torch.randint(0, c, (n,), generator=g, device=self.dev)
        emb = self.b.unit(cent[which] + 0.08 * torch.randn(
            (n, d), generator=g, device=self.dev)).to(torch.bfloat16)
        del cent, which
        n_q = self.BATCHES_D * self.B_MICRO
        gold = torch.randint(0, n, (n_q,), generator=g, device=self.dev)
        q = emb[gold].float()
        q = self.b.unit(q + 0.05 * torch.randn(q.shape, generator=g,
                                             device=self.dev))
        bm25, terms = self.b.planted_bm25(g, n, gold, self.V_D, self.T,
                                          self.DF)
        return emb, gold, q, bm25, terms

    def phase6_stage_d(self):
        p = self.p
        emb, gold, q, bm25, terms = self.stage_d_index()
        n = emb.shape[0]
        sources = [("CG" if i % 2 == 0 else "NG") + str(i // 2)
                   for i in range(n)]
        index = self.make_index(emb, bm25, n, sources)
        assert index.filter_mask_or_none(None) is None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iv = p.attach_ivf(index, MODEL, tile_n=self.TILE_D, n_iters=10,
                          seed=0)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(stage="D_ivf_build", seconds=build_s, n_clusters=iv.n_clusters,
            n_tiles=iv.n_tiles, max_cluster_tiles=iv.max_cluster_tiles,
            tile_n=iv.tile_n)
        kw = dict(use_bm25=True, similarity_k=self.K_D,
                  common_sections_n=self.K_D, budget=1024)
        retr = p.FusedRetriever(index, (MODEL,), nprobe=self.NPROBE_D, **kw)
        exact = p.FusedRetriever(index, (MODEL,), **kw)
        assert retr.use_kernel and exact.use_kernel
        w = {MODEL: 5.0, "BM25": 1.0}
        bm, nb = self.B_MICRO, self.BATCHES_D

        def call(r, i0, b, filt=None):
            return r.retrieve_device({MODEL: q[i0:i0 + b]},
                                     terms[i0:i0 + b], w, filt, 40.0)

        runs, counts = self.main_path(
            lambda: [call(retr, i * bm, bm) for i in range(nb)])
        self.expect("stage D, B=8", counts, ivf_dense_top_k=nb,
                    fused_dense_top_k=0)
        dense = torch.cat([r[2][0] for r in runs])
        fused = torch.cat([r[0] for r in runs])
        r_dense = self.b.recall_at_10(dense, gold)
        r_fused = self.b.recall_at_10(fused, gold)
        assert r_dense >= 0.90, f"2M IVF recall@10 {r_dense} below 0.90"

        wide, c_wide = self.main_path(lambda: call(retr, 0, self.B))
        self.expect("stage D, B=256", c_wide, fused_dense_top_k=1,
                    ivf_dense_top_k=0)
        filt, c_filt = self.main_path(lambda: call(retr, 0, bm, "CG"))
        self.expect("stage D, filtered", c_filt, fused_dense_top_k=1,
                    ivf_dense_top_k=0)
        mask = index.filter_mask("CG")
        for ids in (filt[0], filt[2].reshape(-1, filt[2].shape[-1])):
            live = ids[ids >= 0].long()
            assert bool(mask[live].all()), "an id outside the filter mask"

        full = p.FusedRetriever(index, (MODEL,), nprobe=iv.n_clusters,
                                ivf_route="always", **kw)
        got, c_full = self.main_path(lambda: call(full, 0, bm))
        self.expect("stage D, full probe", c_full, ivf_dense_top_k=1,
                    fused_dense_top_k=0)
        ref = call(exact, 0, bm)
        qb = q[:bm]
        swaps = p.check_top_k(self.b.exact_dense(emb, qb, ref[2][0]),
                              ref[2][0],
                              self.b.exact_dense(emb, qb, got[2][0]),
                              got[2][0], FULL_PROBE_ATOL)
        log(stage="D_2M_ivf", recall10_dense_b8=r_dense,
            recall10_fused_b8=r_fused, calls_b8=nb,
            k3_launches_b8=counts["ivf_dense_top_k"],
            k1_launches_b8=counts["fused_dense_top_k"],
            recall10_dense_b256=self.b.recall_at_10(wide[2][0], gold[:self.B]),
            k1_launches_b256=c_wide["fused_dense_top_k"],
            k1_launches_filtered=c_filt["fused_dense_top_k"],
            full_probe_list_swaps_vs_exact=swaps)
        self.crossover("D_2M_bf16", index, kw, self.NPROBE_D, q, terms, w,
                       self.CROSS_B)
        self.time_ivf_d(emb, q[:bm], iv)
        return index, q, gold

    def crossover(self, label, index, kw, nprobe, q, terms, w,
                  batches) -> None:
        """retrieve_device time of the IVF route (ivf_route="always") and
        of the exact route per batch size, in turns, with the measured
        tile fraction and the analytic coverage the "auto" rule reads."""
        p = self.p
        t = p.cuda_event_ms
        ivf = p.FusedRetriever(index, (MODEL,), nprobe=nprobe,
                               ivf_route="always", **kw)
        exact = p.FusedRetriever(index, (MODEL,), **kw)
        iv = index.ivf[MODEL]
        for b in batches:
            qd = {MODEL: q[:b]}
            tb = None if terms is None else terms[:b]

            def run(r):
                return lambda: r.retrieve_device(qd, tb, w, None, 40.0)

            e1, i1, i2, e2 = t(run(exact)), t(run(ivf)), t(run(ivf)), \
                t(run(exact))
            _, n_unique = p.build_tile_table(
                iv.centroids, iv.cluster_start, q[:b], nprobe=nprobe,
                max_tiles=iv.n_tiles, tile_n=iv.tile_n,
                mct=iv.max_cluster_tiles)
            cov = p.ivf_coverage(b, nprobe, iv.n_clusters)
            log(crossover=label, B=b, ivf_ms=min(i1, i2),
                exact_ms=min(e1, e2), ivf_ms_runs=[i1, i2],
                exact_ms_runs=[e1, e2],
                tile_fraction=int(n_unique) / iv.n_tiles, coverage=cov,
                auto_route="ivf" if cov <= 0.25 else "exact",
                card=self.card)

    def scheduled_rows(self, table, iv) -> torch.Tensor:
        """The real rows the table schedules, ascending."""
        real = table[table >= 0].long()
        rows = (real[:, None] * iv.tile_n
                + torch.arange(iv.tile_n, device=self.dev)).reshape(-1)
        return rows[rows < iv.n_real]

    def time_ivf_d(self, emb, q8, iv) -> None:
        """K3 at stage D's B = 8 table: kernel, plain version, yardstick,
        bound; and K1 at the same B = 8 over the whole corpus."""
        p, k = self.p, self.p.kernels
        table, n_unique = p.build_tile_table(
            iv.centroids, iv.cluster_start, q8, nprobe=self.NPROBE_D,
            max_tiles=p.default_max_tiles(iv, q8.shape[0], self.NPROBE_D),
            tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
        kw = dict(tile_n=iv.tile_n, n_real=iv.n_real)
        kk = self.K_D
        table_ms = p.cuda_event_ms(lambda: p.build_tile_table(
            iv.centroids, iv.cluster_start, q8, nprobe=self.NPROBE_D,
            max_tiles=table.numel(), tile_n=iv.tile_n,
            mct=iv.max_cluster_tiles))
        log(timing="build_tile_table", shape="2^21 x 256 IVF, 1448 "
            f"clusters, B=8, nprobe={self.NPROBE_D}", ms=table_ms,
            card=self.card)
        self.compare("ivf_dense_top_k",
                     k.ivf_dense_top_k_torch(iv.emb, q8, table, kk, **kw),
                     k.ivf_dense_top_k(iv.emb, q8, table, kk, **kw),
                     BF16_ATOL)
        rows = self.scheduled_rows(table, iv)
        shape = (f"2^21 x 256 bf16 IVF, B=8, nprobe={self.NPROBE_D}, "
                 f"k={kk}, {int(n_unique)} of {table.numel()} table slots "
                 f"real, {rows.numel()} rows")
        self.time_pair(
            "ivf_dense_top_k",
            lambda: k.ivf_dense_top_k(iv.emb, q8, table, kk, **kw),
            lambda: k.ivf_dense_top_k_torch(iv.emb, q8, table, kk, **kw),
            shape,
        )

        def library():
            v, i = torch.topk(q8 @ iv.emb.index_select(0, rows).float().T,
                              kk, dim=1)
            return v, rows[i]

        self.time_library(
            "ivf_dense_top_k", library,
            "index_select of the scheduled rows, upcast, f32 matmul, "
            "torch.topk")
        r, (b, d) = rows.numel(), q8.shape
        self.bound("ivf_dense_top_k",
                   r * d * 2 + b * d * 4 + table.numel() * 4 + b * kk * 8,
                   QUERY_PIECES * 2 * b * r * d, BF16_FLOP_S)
        self.time_pair(
            "fused_dense_top_k_b8",
            lambda: k.fused_dense_top_k(emb, q8, kk),
            lambda: k.fused_dense_top_k_torch(emb, q8, kk),
            f"2^21 x 256 bf16 exact, B=8, k={kk} (K1 beside K3)",
        )

    def stage_c_index(self):
        """bench.py's int8 configuration: 4096 cluster centres, doc noise
        0.042, quantized chunk by chunk so the 43 GB f32 matrix never
        exists. Rows are cluster-major: row r belongs to centre r // per."""
        values, scales, cent, g = self.b.int8_corpus(self.b.Int8Config(
            n=self.N_C, dim=self.D_C, clusters=self.CLUSTERS,
            chunks=self.CHUNKS), self.dev)
        gold = torch.randint(0, self.N_C, (self.B,), generator=g,
                             device=self.dev)
        q = self.b.planted_int8_queries(values, scales, gold, g)
        return values, scales, gold, q, cent

    def phase7_stage_c(self):
        p = self.p
        values, scales, gold, q, cent = self.stage_c_index()
        n = values.shape[0]
        meta = p.CorpusMeta(ids=[], sources=[], contents=[], urls=[],
                            n_docs=n, n_docs_padded=n)
        index = p.ArrayIndex(
            meta=meta, dense={}, bm25=None, vocab=None, bm25_stats=None,
            dense_q={MODEL: p.QuantizedDense(values=values, scales=scales)},
        )
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=False,
                                similarity_k=25, common_sections_n=25)
        assert retr.use_kernel, "10.5M int8 config must route to the kernels"
        (fids, _, lists), counts = self.main_path(
            lambda: retr.retrieve_device({MODEL: q}, None, {MODEL: 1.0},
                                         None, 40.0))
        self.expect("stage C", counts, fused_dense_top_k_int8=1)
        r10 = self.b.recall_at_10(fids, gold)
        assert r10 >= 0.95, f"10.5M int8 recall@10 {r10} below 0.95"
        qv, qs = p.quantize_queries(q[:8])
        ref = p.kernels.fused_dense_top_k_int8_torch(values, scales, qv, qs, 25)
        if not torch.equal(lists[0][:8], ref[1]):
            raise AssertionError("stage C ids differ from the plain version")
        got8 = p.kernels.fused_dense_top_k_int8(values, scales, qv, qs, 25)
        self.compare("fused_dense_top_k_int8", ref, got8, 0.0)
        # SearchEngine's plain int8 route at B = 8 ([8, N] f32 scores,
        # 0.34 GB) against K2 on the same queries.
        t0 = time.perf_counter()
        sv, si = p.SearchEngine(index).similarity_search_batch(
            q[:8], MODEL, 25)
        se_swaps = p.check_top_k(got8[0], got8[1], sv, si, INT8_ATOL)
        se_seconds = time.perf_counter() - t0
        self.retrieve_ms["C"] = p.cuda_event_ms(lambda: retr.retrieve_device(
            {MODEL: q}, None, {MODEL: 1.0}, None, 40.0))
        log(stage="C_10.5M_int8", recall10=r10,
            k2_launches=counts["fused_dense_top_k_int8"],
            ids_equal_plain_8_queries=True,
            retrieve_ms=self.retrieve_ms["C"],
            search_engine_b8_vs_k2_swaps=se_swaps,
            search_engine_b8_atol=INT8_ATOL,
            search_engine_b8_seconds=se_seconds)
        return index, q, cent, gold

    def phase8_stage_e(self, index, cent):
        """bench.py's 10.5M int8 IVF: the corpus is already cluster-major,
        so the IVF is free: identity permutation, equal cluster spans, the
        planted centres as centroids; no second copy of the matrix."""
        p = self.p
        qd = index.dense_q[MODEL]
        n, c = qd.values.shape[0], cent.shape[0]
        per = n // c
        iv = p.IVFDense(
            centroids=cent,
            perm=torch.arange(n, dtype=torch.int32, device=self.dev),
            cluster_start=torch.arange(c + 1, dtype=torch.int32,
                                       device=self.dev) * per,
            tile_n=self.TILE_E, n_real=n,
            max_cluster_tiles=per // self.TILE_E + 2,
            values=qd.values, scales=qd.scales,
        )
        index.ivf = {MODEL: iv}
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=False,
                                similarity_k=self.K_E,
                                common_sections_n=self.K_E,
                                nprobe=self.NPROBE_E)
        g = self.seed(29)
        bm, nb = self.B_MICRO, self.BATCHES_E
        gold = torch.randint(0, n, (nb * bm,), generator=g, device=self.dev)
        q = self.b.planted_int8_queries(qd.values, qd.scales, gold, g)
        w = {MODEL: 1.0}
        runs, counts = self.main_path(lambda: [
            retr.retrieve_device({MODEL: q[i * bm:(i + 1) * bm]}, None, w,
                                 None, 40.0) for i in range(nb)])
        self.expect("stage E, B=8", counts, ivf_dense_top_k_int8=nb,
                    fused_dense_top_k_int8=0)
        r10 = self.b.recall_at_10(torch.cat([r[0] for r in runs]), gold)
        assert r10 >= 0.95, f"10.5M int8 IVF recall@10 {r10} below 0.95"
        # All BATCHES_E x B_MICRO = 256 queries at once.
        _, c_wide = self.main_path(lambda: retr.retrieve_device(
            {MODEL: q}, None, w, None, 40.0))
        self.expect(f"stage E, B={q.shape[0]}", c_wide, fused_dense_top_k_int8=1,
                    ivf_dense_top_k_int8=0)
        q8 = q[:bm]
        table, n_unique = p.build_tile_table(
            iv.centroids, iv.cluster_start, q8, nprobe=self.NPROBE_E,
            max_tiles=p.default_max_tiles(iv, bm, self.NPROBE_E),
            tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
        qv, qs = p.quantize_queries(q8)
        args = (iv.values, iv.scales, qv, qs, table, self.K_E)
        kw = dict(tile_n=iv.tile_n, n_real=iv.n_real)
        ref = p.kernels.ivf_dense_top_k_int8_torch(*args, **kw)
        got = p.kernels.ivf_dense_top_k_int8(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])):
            raise AssertionError("stage E: K4 differs from its plain version")
        self.compare("ivf_dense_top_k_int8", ref, got, 0.0)
        self.crossover("E_10.5M_int8", index,
                       dict(use_bm25=False, similarity_k=self.K_E,
                            common_sections_n=self.K_E),
                       self.NPROBE_E, q, None, w, (bm,))
        log(stage="E_10.5M_int8_ivf", recall10_b8=r10, calls_b8=nb,
            k4_launches_b8=counts["ivf_dense_top_k_int8"],
            k2_launches_b8=counts["fused_dense_top_k_int8"],
            k2_launches_b256=c_wide["fused_dense_top_k_int8"],
            ids_equal_plain_8_queries=True)
        self.time_ivf_e(iv, qv, qs, table, n_unique)

    def time_ivf_e(self, iv, qv, qs, table, n_unique) -> None:
        """K4 at stage E's B = 8 table: kernel, plain version, yardstick,
        bound; and K2 at the same B = 8 over the whole corpus."""
        k = self.p.kernels
        kk, b = self.K_E, qv.shape[0]
        args = (iv.values, iv.scales, qv, qs, table, kk)
        kw = dict(tile_n=iv.tile_n, n_real=iv.n_real)
        rows = self.scheduled_rows(table, iv)
        self.time_pair(
            "ivf_dense_top_k_int8",
            lambda: k.ivf_dense_top_k_int8(*args, **kw),
            lambda: k.ivf_dense_top_k_int8_torch(*args, **kw),
            f"10,485,760 x 1024 int8 IVF, B=8, nprobe={self.NPROBE_E}, "
            f"k={kk}, {int(n_unique)} of {table.numel()} table slots real, "
            f"{rows.numel()} rows",
        )
        # torch._int_mm needs more than 16 rows: the 8 queries are padded
        # with zero rows to 32.
        qv32 = torch.cat([qv, qv.new_zeros((32 - b, qv.shape[1]))])

        def library():
            acc = torch._int_mm(qv32, iv.values.index_select(0, rows).T)[:b]
            v, i = torch.topk(acc.float() * iv.scales[rows][None, :], kk,
                              dim=1)
            return v * qs[:, None], rows[i]

        self.time_library(
            "ivf_dense_top_k_int8", library,
            "index_select of the scheduled rows, torch._int_mm (queries "
            "padded to 32 rows), row scales, torch.topk, query scales")
        r, d = rows.numel(), qv.shape[1]
        self.bound("ivf_dense_top_k_int8",
                   r * d + r * 4 + b * (d + 4) + table.numel() * 4
                   + b * kk * 8, 2 * b * r * d, INT8_OP_S)
        self.time_pair(
            "fused_dense_top_k_int8_b8",
            lambda: k.fused_dense_top_k_int8(iv.values, iv.scales, qv, qs,
                                             kk),
            lambda: k.fused_dense_top_k_int8_torch(iv.values, iv.scales, qv,
                                                   qs, kk),
            f"10,485,760 x 1024 int8 exact, B=8, k={kk} (K2 beside K4)",
        )

    def time_k2(self, values, scales, q) -> None:
        """K2 at stage C's shape: kernel, plain version, yardstick, bound."""
        k = self.p.kernels
        qv, qs = self.p.quantize_queries(q)
        self.time_pair(
            "fused_dense_top_k_int8",
            lambda: k.fused_dense_top_k_int8(values, scales, qv, qs, 25),
            lambda: k.fused_dense_top_k_int8_torch(values, scales, qv, qs, 25),
            "10,485,760 x 1024 int8, B=256, k=25, no mask",
        )
        (n, d), b = values.shape, q.shape[0]
        step = 1 << 21

        def library():
            # Chunked over the doc axis: the [256, 10.5M] int32 and f32
            # score matrices would take 21 GB at once.
            vs, ids = [], []
            for s0 in range(0, n, step):
                acc = torch._int_mm(qv, values[s0:s0 + step].T)
                v, i = torch.topk(acc.float() * scales[s0:s0 + step][None],
                                  25, dim=1)
                vs.append(v)
                ids.append(i + s0)
            v, i = torch.topk(torch.cat(vs, dim=1), 25, dim=1)
            return v * qs[:, None], torch.take_along_dim(
                torch.cat(ids, dim=1), i, dim=1)

        self.time_library(
            "fused_dense_top_k_int8", library,
            f"torch._int_mm, row scales, torch.topk per {step}-row chunk of "
            f"the doc axis, torch.topk over the chunks, query scales")
        self.bound("fused_dense_top_k_int8",
                   n * d + n * 4 + b * (d + 4) + b * 25 * 8, 2 * b * n * d,
                   INT8_OP_S)

    def time_pair(self, name, kernel_fn, plain_fn, shape,
                  plain_n=10) -> None:
        """plain_n < 10 for plain versions that take a tenth of a second
        or more: their median of plain_n calls after one warm-up, or, for
        plain_n = 1 (seconds a call), one call without a warm-up."""
        t = self.p.cuda_event_ms
        warmup = 0 if plain_n == 1 else 1

        def plain():
            return t(plain_fn) if plain_n == 10 else t(plain_fn, n=plain_n,
                                                       warmup=warmup)
        # plain, kernel, kernel, plain: drift shows as a gap between pairs.
        p1 = plain()
        k1 = t(kernel_fn)
        k2 = t(kernel_fn)
        p2 = plain()
        ms, plain_ms = min(k1, k2), min(p1, p2)
        self.times[name] = (ms, plain_ms)
        log(timing=name, shape=shape, ms=ms, plain_ms=plain_ms,
            ms_runs=[k1, k2], plain_ms_runs=[p1, p2], card=self.card,
            method="CUDA events, median of 10 after 3 warm-ups"
            + ("" if plain_n == 10 else
               f" (plain: median of {plain_n} after {warmup} warm-up)"))

    def time_library(self, name, fn, what) -> None:
        t = self.p.cuda_event_ms
        runs = [t(fn), t(fn)]
        self.library[name] = min(runs)
        log(timing=name + "_library", what=what, ms=min(runs), ms_runs=runs,
            card=self.card)

    def no_library(self, name, why) -> None:
        self.library[name] = None
        log(timing=name + "_library", ms=None, what="none: " + why)

    # -- the bench's paths: stream kernels, stage F, floors, overlap -------

    def stream_parts(self, g, dtype, m, rows, cols):
        if dtype == torch.int8:
            return [torch.randint(-127, 128, (rows, cols), generator=g,
                                  device=self.dev, dtype=torch.int8)
                    for _ in range(m)]
        return [torch.randn((rows, cols), generator=g,
                            device=self.dev).to(dtype) for _ in range(m)]

    def check_stream(self, parts, bias=None, **launch) -> None:
        err = self.p.check_stream_sum(parts, bias, **launch)
        self.max_err["stream_sum"] = max(self.max_err["stream_sum"], err)

    def phase9_stream_kernels(self) -> None:
        """stream_sum and stream_sum_busy against their plain versions."""
        k = self.p.kernels
        g = self.seed(61)
        rows, d = self.STREAM_ROWS, self.STREAM_D
        bias = torch.tensor([3.25], device=self.dev)
        cases = 0
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for m in (1, 2, 8):
                parts = self.stream_parts(g, dtype, m, rows, d)
                for b in (None, bias):
                    self.check_stream(parts, b)
                    cases += 1
            self.check_stream(self.stream_parts(g, dtype, 1, 1, 7), bias)
            flat = parts[0].reshape(-1)
            for start in (1, 3):  # views that start mid-vector
                assert flat[start:].data_ptr() % 16 != 0
                self.check_stream(flat[start:])
            cases += 3
        # Every partial sum below 2^24: float32 holds it exactly, so a
        # dropped or doubled tile would show.
        x = torch.randint(0, 2, (self.EXACT_ROWS, 15), generator=g,
                          device=self.dev, dtype=torch.int8)
        want = int(x.sum(dtype=torch.int64))
        assert want < 2 ** 24
        if float(k.stream_sum(x)) != float(want):
            raise AssertionError("the int8 exact case is not exact")
        # One launch a call, its partials and ticket kept across calls:
        # every launch shape against the plain version, and two calls of
        # each the same bits.
        y = self.stream_parts(g, torch.bfloat16, 1, rows, d)[0]
        shapes = [dict(ctas_per_sm=c, unroll=u)
                  for c in self.STREAM_CTAS for u in k.stream.UNROLLS]
        for launch in shapes:
            self.check_stream([y, y[1:]], **launch)
            before = k.stream_sum.launches
            first = k.stream_sum(y, **launch)
            second = k.stream_sum(y, **launch)
            if k.stream_sum.launches != before + 2:
                raise AssertionError("stream_sum counted other than one "
                                     "launch a call")
            if not torch.equal(first, second):
                raise AssertionError(f"stream_sum {launch}: two calls differ")
        cases += len(shapes)
        grid = self.p.sm_grid(self.dev)
        seed = torch.tensor(0.5, device=self.dev)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            (emb,) = self.stream_parts(g, dtype, 1, rows, d)
            for xi in self.BUSY_X:
                err = self.p.check_stream_sum_busy(emb, seed, xi, grid, 16)
                self.max_err["stream_sum_busy"] = max(
                    self.max_err["stream_sum_busy"], err)
        log(phase="stream_vs_plain", cases=cases, int8_exact=True,
            launch_shapes=len(shapes), two_calls_bit_equal=True,
            busy_cases=3 * len(self.BUSY_X), busy_chains_bit_equal=True,
            ok=True, max_abs_err=self.max_err["stream_sum"],
            max_abs_err_busy=self.max_err["stream_sum_busy"])

    def phase10_stage_f(self) -> None:
        """The bench's headline stage at full width, through its own
        function: recall guards and route parity inside."""
        b = self.p.bench
        cfg = b.HeadlineConfig(**self.HEADLINE)
        out, counts = self.main_path(
            lambda: b.headline_stage(self.dev, 1, self.timer, cfg))
        # 9,728 docs are below the kernel threshold: both routes are torch.
        self.expect("stage F", counts, fused_dense_top_k=0)
        assert not out["kernel_route_headline"]
        log(stage="F_headline", card=self.card,
            **{key: v for key, v in out.items() if not key.endswith("_runs")})

    def phase11_floor(self, stage, mat) -> None:
        """The bench's stream floor over a stage's matrix, against the
        stage's retrieve_device time, beside the library's sum."""
        out, counts = self.main_path(
            lambda: self.p.bench.stream_floor(mat, self.timer, repeats=2))
        if counts["stream_sum"] < 1:
            raise AssertionError("the floor never launched stream_sum")
        lib = self.p.cuda_event_ms(lambda: torch.sum(mat, dtype=torch.float32))
        n, d = mat.shape
        log(floor=stage, shape=f"{n} x {d} {str(mat.dtype)[6:]}",
            stream_ms=out["stream_ms"],
            stream_ms_runs=[out["stream_ms_runs"]["min"],
                            out["stream_ms_runs"]["max"]],
            gb_s=out["stream_gb_s"], retrieve_ms=self.retrieve_ms[stage],
            pct_of_floor=out["stream_ms"] / self.retrieve_ms[stage],
            library_sum_ms=lib, library="torch.sum(x, dtype=torch.float32)",
            stream_sum_launches=counts["stream_sum"], card=self.card)

    def phase12_overlap(self, emb) -> None:
        """The overlap probe on stage A's matrix: ms against X."""
        grid = self.p.sm_grid(self.dev)
        lines, counts = self.main_path(lambda: self.p.dma_overlap.run(
            emb, self.timer.device_ms, grid, xs=self.OVERLAP_X, n_loop=10))
        if counts["stream_sum_busy"] < 1:
            raise AssertionError("the probe never launched stream_sum_busy")
        n, d = emb.shape
        log(probe="dma_overlap", shape=f"{n} x {d} bf16, tiles of "
            f"{lines[0]['tile_rows']} rows, grid {grid}",
            x_iters=[r["x_iters"] for r in lines],
            ms=[r["ms"] for r in lines],
            added_ms=[r["added_ms"] for r in lines],
            ns_per_step_per_cta=[r["ns_per_step_per_cta"] for r in lines],
            stream_gb_s=[r["stream_gb_s"] for r in lines],
            chains_bit_equal=True, card=self.card)

    def time_stream(self, emb) -> None:
        """stream_sum and stream_sum_busy (X = 8) at stage A's matrix:
        kernel, plain version, yardstick, bound."""
        k = self.p.kernels
        n, d = emb.shape
        self.time_pair("stream_sum", lambda: k.stream_sum(emb),
                       lambda: k.stream_sum_torch(emb),
                       f"{n} x {d} bf16 (stage A's matrix)")
        self.time_library("stream_sum",
                          lambda: torch.sum(emb, dtype=torch.float32),
                          "torch.sum(x, dtype=torch.float32)")
        self.bound("stream_sum", n * d * 2 + 4, n * d, F32_FLOP_S)
        grid, xi, tile_rows = self.p.sm_grid(self.dev), 8, 16
        seed = torch.zeros((), device=self.dev)
        self.time_pair(
            "stream_sum_busy",
            lambda: k.stream_sum_busy(emb, seed, xi, grid, tile_rows),
            lambda: k.stream_sum_busy_torch(emb, seed, xi, grid, tile_rows),
            f"{n} x {d} bf16, X={xi}, tiles of {tile_rows} rows, "
            f"grid {grid}")
        self.no_library("stream_sum_busy",
                        "no PyTorch call computes the per-CTA chains")
        tiles = -(-n // tile_rows)
        # Each tile: n*d/tiles adds; every thread of its CTA: X chain steps
        # of a multiply and an add.
        self.bound("stream_sum_busy", n * d * 2 + 4 + grid * 4,
                   n * d + 2 * xi * tiles * 256, F32_FLOP_S)

    # -- the probes of K1/K2, the keys and int4 (P4-P7, T1) --------------

    def probe_ms(self, fn, n):
        return self.p.cuda_event_ms(fn, n=n, warmup=1)

    def exact_rows(self, n, d):
        """Integer-valued rows and queries: every f32 score is an exact
        integer, so the kernels' sums and the plain versions' agree bit
        for bit, and exact ties are everywhere. Also int8 rows with
        scales (float(acc) * scale is one rounding in both)."""
        g = self.seed(131)
        dev = self.dev
        emb = torch.randint(-2, 3, (n, d), generator=g,
                            device=dev).to(torch.bfloat16)
        q = torch.randint(-2, 3, (self.B, d), generator=g, device=dev).float()
        i8 = dict(generator=g, device=dev, dtype=torch.int8)
        int8 = (torch.randint(-127, 128, (n, d), **i8),
                torch.rand(n, generator=g, device=dev) + 0.5,
                torch.randint(-127, 128, (self.B, d), **i8),
                torch.rand(self.B, generator=g, device=dev) + 0.5)
        return emb, q, int8

    def counted_check(self, name, counted, plain, kernel, tau_fn) -> None:
        """The counted fold equal to its plain version (values, ids and
        every counter) and to the kernel it counts, with and without
        tau."""
        ref = kernel()
        for tau in (None, tau_fn()):
            got, want = counted(tau), plain(tau)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"(tau={tau is not None})")
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise AssertionError(f"{name} differs from the kernel it "
                                     f"counts (tau={tau is not None})")

    def phase13_14_probe_checks(self) -> None:
        """P4's modes and P5's counted fold against their plain versions
        at N_KERNEL, on exact rows."""
        t0 = time.perf_counter()
        k, a = self.p.kernels, self.p.anatomy
        emb, q, (values, scales, qv, qs) = self.exact_rows(self.N_KERNEL,
                                                           self.D_KERNEL)
        self.max_err["anatomy_top_k"] = self.p.kernel_anatomy.check(emb, q, 32)
        self.max_err["anatomy_top_k_int8"] = self.p.kernel_anatomy.check(
            values, qv, 25, scales, qs)
        self.counted_check(
            "fused_top_k_counted",
            lambda t: k.fused_top_k_counted(emb, q, 32, t),
            lambda t: k.fused_top_k_counted_torch(emb, q, 32, t),
            lambda: k.fused_dense_top_k(emb, q, 32),
            lambda: a.subsample_tau(emb, q, 32))
        args = (values, scales, qv, qs, 25)
        self.counted_check(
            "fused_top_k_counted_int8",
            lambda t: k.fused_top_k_counted_int8(*args, t),
            lambda t: k.fused_top_k_counted_int8_torch(*args, t),
            lambda: k.fused_dense_top_k_int8(*args),
            lambda: a.subsample_tau_int8(values, scales, qv, 25))
        log(phase="probes_vs_plain", n=self.N_KERNEL, d=self.D_KERNEL,
            b=self.B, anatomy_modes=["stage", "score", "compare", "full"],
            anatomy_score_max_abs_err=self.max_err["anatomy_top_k"],
            counted_equal_plain_and_kernel=True, tau=[False, True], ok=True,
            seconds=time.perf_counter() - t0)

    def phase13_anatomy(self, label, rows, q, kk, scales=None,
                        q_scales=None) -> None:
        """Every mode held against its plain version on a stage's matrix,
        the ablation's times there, and the anatomy row's timing (its
        "score" mode) beside its plain version and yardstick. The probe's
        K1/K2 calls (its "full" mode) are reported in the anatomy line,
        not in the kernels line."""
        t0 = time.perf_counter()
        int8 = scales is not None
        name = "anatomy_top_k_int8" if int8 else "anatomy_top_k"
        full = "fused_dense_top_k_int8" if int8 else "fused_dense_top_k"
        err = self.p.kernel_anatomy.check(rows, q, kk, scales, q_scales)
        self.max_err[name] = max(self.max_err[name], err)
        line, counts = self.main_path(lambda: self.p.kernel_anatomy.run(
            rows, q, kk, self.probe_ms, scales, q_scales), probed=(full,))
        self.expect(f"anatomy {label}", counts, **{name: 3 * counts[full]})
        (n, d), b = rows.shape, q.shape[0]
        shape = (f"{n} x {d} {line['rows']}, B={b}, k={kk}, "
                 f"{line['splits']} splits")
        log(anatomy=label, shape=shape, **{key: line[key] for key in (
            "ms", "loads_ms", "scoring_ms", "compare_ms", "insert_merge_ms",
            "tau_pass_ms", "stage_gb_s", "byte_floor_ms")}, modes_equal_plain=True,
            score_max_abs_err=err, full_mode_launches=counts[full],
            card=self.card, seconds=time.perf_counter() - t0)
        k = self.p.kernels
        if int8:
            args = (rows, scales, q, q_scales, kk, "score")
            self.time_pair(name, lambda: k.anatomy_top_k_int8(*args),
                           lambda: k.anatomy_top_k_int8_torch(*args),
                           shape + ", mode score", plain_n=2)
            self.time_library(name, lambda: self.int8_row_max(rows, q,
                                                              scales),
                              "torch._int_mm, row scales, amax per 2^21-row "
                              "chunk, then the max over chunks")
            self.bound(name, n * d + n * 4 + b * d + b * 4, 2 * b * n * d,
                       INT8_OP_S)
        else:
            args = (rows, q, kk, "score")
            self.time_pair(name, lambda: k.anatomy_top_k(*args),
                           lambda: k.anatomy_top_k_torch(*args),
                           shape + ", mode score")
            self.time_library(name, lambda: torch.amax(
                q.float() @ rows.float().T, dim=1),
                "torch.amax(q @ emb.float().T, dim=1)")
            self.bound(name, n * d * 2 + b * d * 4 + b * 4,
                       QUERY_PIECES * 2 * b * n * d, BF16_FLOP_S)

    @staticmethod
    def int8_row_max(values, qv, scales=None, step=1 << 21):
        """Each row's best int8 product (times the row scales, if given):
        torch._int_mm per chunk of the doc axis, whose [256, N] int32
        product would take 10.7 GB at once."""
        best = None
        for s0 in range(0, values.shape[0], step):
            acc = torch._int_mm(qv, values[s0:s0 + step].T)
            m = (acc if scales is None else
                 acc.float() * scales[s0:s0 + step][None]).amax(dim=1)
            best = m if best is None else torch.maximum(best, m)
        return best

    def phase14_counted(self, label, rows, q, kk, scales=None,
                        q_scales=None) -> None:
        """The counted fold on a stage's matrix with and without tau, its
        values, ids and every counter equal to its plain version's and its
        ids to K1's / K2's (inside the probe), and its timing row. The
        probe's K1/K2 call (the reference) is reported in the counted
        line, not in the kernels line; tau comes from K1/K2's own tau
        pass (subsample_tau)."""
        t0 = time.perf_counter()
        int8 = scales is not None
        name = "fused_top_k_counted_int8" if int8 else "fused_top_k_counted"
        full = "fused_dense_top_k_int8" if int8 else "fused_dense_top_k"
        lines, counts = self.main_path(lambda: self.p.iteration_count.run(
            rows, q, kk, self.probe_ms, scales, q_scales), probed=(full,))
        self.expect(f"counted {label}", counts, at_least=True, **{name: 2})
        (n, d), b = rows.shape, q.shape[0]
        shape = (f"{n} x {d} {'int8' if int8 else str(rows.dtype)[6:]}, "
                 f"B={b}, k={kk}, {lines[0]['splits']} splits")
        keys = ("insertions_per_row", "insertions_early_per_row",
                "insertions_late_per_row", "insertions_per_row_split",
                "fired_windows_per_row", "windows_per_row", "fired_share",
                "counters_off_plain", "ms")
        # One list per key: without tau, then with it.
        log(counted=label, shape=shape, ids_equal_kernel=True,
            equal_plain=True, tau=[False, True],
            reference_launches=counts[full],
            **{key: [line[key] for line in lines] for key in keys},
            card=self.card, seconds=time.perf_counter() - t0)
        shape += ", no tau"
        k = self.p.kernels
        if int8:
            args = (rows, scales, q, q_scales, kk)
            self.time_pair(name, lambda: k.fused_top_k_counted_int8(*args),
                           lambda: k.fused_top_k_counted_int8_torch(*args),
                           shape, plain_n=1)
            self.bound(name, n * d + n * 4 + b * (d + 4)
                       + b * lines[0]["splits"] * 16 + b * kk * 8,
                       2 * b * n * d, INT8_OP_S)
        else:
            self.time_pair(name, lambda: k.fused_top_k_counted(rows, q, kk),
                           lambda: k.fused_top_k_counted_torch(rows, q, kk),
                           shape, plain_n=1)
            self.bound(name, n * d * rows.element_size() + b * d * 4
                       + b * lines[0]["splits"] * 16 + b * kk * 8,
                       QUERY_PIECES * 2 * b * n * d, BF16_FLOP_S)
        self.no_library(name, "no PyTorch call counts a top-k's insertions")

    def phase15_keys(self) -> None:
        """T1 bit for bit over the JAX package's special values and 2^24
        normals; P6 through its probe."""
        t0 = time.perf_counter()
        k = self.p.kernels
        inf = float("inf")
        special = torch.tensor(
            [-inf, -3.3e38, -1.0, -2e-38, -1e-45, -0.0, 0.0, 1e-45, 2e-38,
             0.5, 1.0, 3.3e38, inf], dtype=torch.float32, device=self.dev)
        g = self.seed(151)
        x = torch.cat([special, 10 * torch.randn(
            self.KEY_NORMALS, generator=g, device=self.dev)])

        def keys_and_back():
            keys = k.xpack_keys(x)
            return keys, k.xpack_values(keys)

        (keys, back), counts = self.main_path(keys_and_back)
        self.expect("keys", counts, xpack_keys=1, xpack_values=1)
        if not (torch.equal(keys, k.xpack_keys_torch(x))
                and torch.equal(back.view(torch.int32), x.view(torch.int32))
                and torch.equal(k.xpack_values_torch(keys).view(torch.int32),
                                x.view(torch.int32))):
            raise AssertionError("the key map is not bit-exact")
        ordered = x[torch.argsort(keys)]
        if not bool((ordered[1:] >= ordered[:-1]).all()):
            raise AssertionError("the keys do not order as the floats")
        for name in ("xpack_keys", "xpack_values"):
            self.max_err[name] = 0.0
        lines, c6 = self.main_path(lambda: self.p.bf16_fold.run(
            self.dev, self.probe_ms, self.BF16_SHAPES))
        self.expect("bf16 fold", c6, at_least=True,
                    bf16_row_reduce=len(lines))
        self.max_err["bf16_row_reduce"] = 0.0
        t1 = time.perf_counter()
        edges = self.p.bf16_fold.check_edges(
            self.dev, *(() if self.BF16_EDGE_SHAPES is None
                        else (self.BF16_EDGE_SHAPES,)))
        log(probe="bf16_row_reduce_edges", **edges, card=self.card,
            seconds=time.perf_counter() - t1)
        log(probe="keys", elements=x.numel(), special_values=13,
            bit_equal_plain=True, round_trip_bit_equal=True, monotone=True,
            bf16_fold=[{key: line[key] for key in (
                "shape", "ms", "plain_ms", "packed_argmax_agreement",
                "packed_value_agreement")} for line in lines],
            card=self.card, seconds=time.perf_counter() - t0)
        n = x.numel()
        self.time_pair("xpack_keys", lambda: k.xpack_keys(x),
                       lambda: k.xpack_keys_torch(x),
                       f"{n} float32 (13 special + normals)")
        self.time_pair("xpack_values", lambda: k.xpack_values(keys),
                       lambda: k.xpack_values_torch(keys),
                       f"{n} int32 keys")
        for name in ("xpack_keys", "xpack_values"):
            self.no_library(name, "no PyTorch call maps floats to "
                            "order-preserving int32 keys")
            self.bound(name, 8 * n, n, F32_FLOP_S)
        self.time_row_reduce(g)
        r, w = self.BF16_SHAPES[-1]
        xr = torch.randn((r, w), generator=g, device=self.dev)
        self.time_pair("bf16_row_reduce", lambda: k.bf16_row_reduce(xr),
                       lambda: k.bf16_row_reduce_torch(xr),
                       f"[{r}, {w}] float32")
        self.no_library("bf16_row_reduce", "torch.max gives the max and an "
                        "argmax only, not the masked max or the packed key")
        self.bound("bf16_row_reduce", r * w * 4 + r * 16, 6 * r * w,
                   F32_FLOP_S)

    def time_row_reduce(self, g) -> None:
        """P6 at both probe shapes, warm (one input, which stays in the 50
        MB L2) and cold (copies filling twice the L2, taken in turn): the
        event pair around one call (median of 10; the wrapper's host work
        falls inside it), 50 calls back to back between one pair of events
        (the device loop; host-bound where the wrapper outlasts the
        kernel), the kernel alone (torch.profiler, mean of 50 launches)
        and the wrapper's host time, beside the HBM bound."""
        k, p = self.p.kernels, self.p
        shapes = []
        for r, w in self.BF16_SHAPES:
            xs = p.bf16_fold.cold_inputs(r, w, g, self.dev)
            turn = itertools.cycle(xs)

            def warm(x=xs[0]):
                return k.bf16_row_reduce(x)

            def cold():
                return k.bf16_row_reduce(next(turn))

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                warm()
            host_ms = (time.perf_counter() - t0) / 50 * 1e3
            shapes.append({
                "shape": [r, w], "cold_copies": len(xs),
                "plan": {"threads_per_row": p.row_plan(w)},
                "event_ms": p.cuda_event_ms(warm),
                "event_cold_ms": p.cuda_event_ms(cold),
                "device_ms": p.device_loop_ms(warm, n_loop=50, trials=3),
                "kernel_ms": p.profiled_kernel_ms(warm, "row_reduce", n=50),
                "kernel_cold_ms": p.profiled_kernel_ms(cold, "row_reduce",
                                                       n=50),
                "host_ms": host_ms,
                "plain_event_ms": p.cuda_event_ms(
                    lambda: k.bf16_row_reduce_torch(xs[0])),
                "bound_ms": (r * w * 4 + r * 16) / HBM_BYTES_S * 1e3,
            })
            del xs, turn
        log(timing="bf16_row_reduce_shapes", shapes=shapes,
            predicted_event_ms=list(self.P6_PREDICTED_MS), card=self.card,
            method="event_ms: CUDA events around one call, median of 10 "
            "after 3 warm-ups; device_ms: 50 calls between one pair of "
            "events, best of 3; kernel_ms: torch.profiler device time per "
            "launch over 50 calls; host_ms: host clock over 50 calls "
            "without a synchronize")

    def phase16_int4_exact(self) -> None:
        """P7 stages 1 and 3: exact at the probe's small shape."""
        t0 = time.perf_counter()
        probe = self.p.int4_probe
        line, counts = self.main_path(lambda: probe.check_exact(self.dev))
        self.expect("int4 exact", counts, at_least=True, int4_scores=2,
                    int4_fold_max=2, int8_fold_max=1)
        for name in ("int4_scores", "int4_fold_max", "int8_fold_max"):
            self.max_err[name] = 0.0
        q8, e4, packed = probe.small_case(self.dev)
        k = self.p.kernels
        (n, d), b = e4.shape, q8.shape[0]
        self.time_pair("int4_scores", lambda: k.int4_scores(q8, packed),
                       lambda: k.int4_scores_torch(q8, packed),
                       f"{n} x {d} int4 ({n} x {d // 2} packed), B={b}")
        self.no_library("int4_scores", "no PyTorch call multiplies packed "
                        "int4 rows")
        self.bound("int4_scores", b * d + n * d // 2 + b * n * 4,
                   2 * b * n * d, INT8_OP_S)
        log(probe="int4_exact", **line, card=self.card,
            seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        edges = probe.check_edges(self.dev, self.FOLD_EDGE_N,
                                  self.FOLD_EDGE_D, self.FOLD_EDGE_B)
        log(probe="int4_edges", **edges, card=self.card,
            seconds=time.perf_counter() - t0)

    def phase16_int4_stage2(self, values) -> None:
        """P7 stage 2: the int8 fold over stage C's resident matrix, the
        int4 fold over a seeded packed matrix of as many rows."""
        t0 = time.perf_counter()
        probe, k = self.p.int4_probe, self.p.kernels
        n, d = values.shape
        q8, packed = probe.stage2_inputs(self.dev, self.INT4_N, d, self.B)
        checks = [("int8_fold_max", k.int8_fold_max(q8, values),
                   k.int8_fold_max_torch(q8, values))]
        for unpack in ("mask", "shift"):
            checks.append((f"int4_fold_max ({unpack})",
                           k.int4_fold_max(q8, packed, unpack),
                           k.int4_fold_max_torch(q8, packed, unpack)))
        for what, got, want in checks:
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{what} is not exact at full size")
        del checks
        for unpack in ("mask", "shift"):
            # [256, N] int32 at once; the plain version a slice at a time.
            got = k.int4_scores(q8, packed, unpack)
            step = 1 << 21
            for s0 in range(0, packed.shape[0], step):
                if not torch.equal(got[:, s0:s0 + step], k.int4_scores_torch(
                        q8, packed[s0:s0 + step], unpack)):
                    raise AssertionError(f"int4_scores ({unpack}) is not "
                                         f"exact at full size")
            del got
        lines, counts = self.main_path(lambda: probe.run_stage2(
            q8, values, packed, self.probe_ms))
        self.expect("int4 stage 2", counts, at_least=True, int8_fold_max=1,
                    int4_fold_max=1)
        anatomy, _ = self.main_path(lambda: probe.run_anatomy(
            q8, values, packed, self.probe_ms))
        log(probe="int4_anatomy", lines=anatomy, card=self.card)
        log(probe="int4_stage2", lines=lines, exact_full_size=True,
            exact_full_size_kernels=["int8_fold_max", "int4_fold_max mask",
                                     "int4_fold_max shift",
                                     "int4_scores mask", "int4_scores shift"],
            card=self.card, seconds=time.perf_counter() - t0)
        b = q8.shape[0]
        np_ = packed.shape[0]
        self.time_pair("int8_fold_max", lambda: k.int8_fold_max(q8, values),
                       lambda: k.int8_fold_max_torch(q8, values),
                       f"{n} x {d} int8, B={b}", plain_n=2)
        self.time_library("int8_fold_max",
                          lambda: self.int8_row_max(values, q8),
                          "torch._int_mm and amax per 2^21-row chunk, then "
                          "the max over chunks")
        self.bound("int8_fold_max", n * d + b * d + b * 4, 2 * b * n * d,
                   INT8_OP_S)
        self.time_pair("int4_fold_max", lambda: k.int4_fold_max(q8, packed),
                       lambda: k.int4_fold_max_torch(q8, packed),
                       f"{np_} x {d} int4 ({np_} x {d // 2} packed), B={b}",
                       plain_n=2)
        self.no_library("int4_fold_max", "no PyTorch call multiplies packed "
                        "int4 rows")
        self.bound("int4_fold_max", np_ * d // 2 + b * d + b * 4,
                   2 * b * np_ * d, INT8_OP_S)

    # -- phase 19: the sharded path --------------------------------------

    def slot_mesh(self, n, dp=1):
        """dp x n/dp slots, every one on this card: a virtual mesh."""
        return self.p.make_mesh(shape=(dp, n // dp), devices=[self.dev] * n)

    def shard_timed(self, fn):
        """(fn(), seconds, bytes it left allocated on the card)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                torch.cuda.memory_allocated() - before)

    def shard_lists_vs_plain(self, sidx, q, k) -> None:
        """Each shard's K1 list against its plain version."""
        kern = self.p.kernels
        for sh in sidx.shards:
            mat = sh.dense[MODEL]
            self.compare("fused_dense_top_k",
                         kern.fused_dense_top_k_torch(mat, q, k),
                         kern.fused_dense_top_k(mat, q, k), BF16_ATOL)

    def device_profile(self, fn, n=5) -> dict:
        """One call of ``fn``: its kernels' device time and launches
        (``torch.profiler`` over n calls), its CUDA-event time without the
        profiler, the idle share of that time, and the host's median time
        to enqueue it (no synchronize inside)."""
        device_ms, launches = self.p.profiled_device_ms(fn, n)
        enqueue = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        event_ms = self.p.cuda_event_ms(fn)
        return {"device_ms": device_ms, "kernel_launches": launches,
                "event_ms": event_ms,
                "idle_share": max(0.0, 1.0 - device_ms / event_ms),
                "enqueue_ms": statistics.median(enqueue)}

    def phase19a_sharded(self, emb, gold, q, bm25, terms):
        """Stage A's index over N_SLOTS corpus slots: K1 per shard, the
        exact merge against unsharded K1 and the fused retriever, the
        torch route at B = 8, and the times beside the unsharded ones."""
        p, b = self.p, self.b
        n = emb.shape[0]
        index = self.make_index(emb, bm25, n)
        sidx, secs, alloc = self.shard_timed(
            lambda: p.shard_index(index, self.slot_mesh(self.N_SLOTS)))
        self.shard_seconds["A"] = secs
        (sv, si), c_dense = self.main_path(
            lambda: p.sharded_dense_top_k(sidx, MODEL, q, 32))
        self.expect("sharded A, dense", c_dense,
                    fused_dense_top_k=self.N_SLOTS)
        kv, ki = p.kernels.fused_dense_top_k(emb, q, 32)
        torch.cuda.synchronize()
        if not torch.equal(si, ki):
            raise AssertionError("sharded dense ids differ from K1's")
        dense_err = float((sv - kv).abs().max())
        assert dense_err <= F32_ATOL, dense_err

        kw = dict(similarity_k=32, common_sections_n=15, budget=1024)
        w = {MODEL: 5.0, "BM25": 1.0}
        qd = {MODEL: q}
        retr = p.ShardedRetriever(sidx, (MODEL,), use_bm25=True, **kw)
        assert retr.use_kernel, "stage A's shards must route to the kernels"
        got, counts = self.main_path(
            lambda: retr.retrieve_lists(qd, terms, w, None, 40.0))
        self.expect("sharded A", counts, fused_dense_top_k=self.N_SLOTS)
        recall = b.recall_at_10(got[0], gold)
        assert recall >= 0.99, f"sharded hybrid recall@10 {recall} < 0.99"
        flat = p.FusedRetriever(index, (MODEL,), use_bm25=True, **kw)
        rescore = [lambda ids: b.exact_dense(emb, q, ids),
                   lambda ids: b.exact_bm25_uniform(bm25, terms, self.DF,
                                                    ids)]
        vs_flat = b.assert_route_parity(
            got, flat.retrieve_device(qd, terms, w, None, 40.0), rescore,
            [F32_ATOL, BM25_ATOL])

        # B = 8: the torch route per shard, and each shard's K1 list
        # against its plain version.
        q8, t8 = q[:8], terms[:8]
        torch_retr = p.ShardedRetriever(sidx, (MODEL,), use_bm25=True,
                                        dense_backend="torch", **kw)
        assert not torch_retr.use_kernel
        got8, c8 = self.main_path(
            lambda: retr.retrieve_lists({MODEL: q8}, t8, w, None, 40.0))
        self.expect("sharded A, B=8", c8, fused_dense_top_k=self.N_SLOTS)
        ref8 = self.no_kernels("sharded A, torch route", lambda: (
            torch_retr.retrieve_lists({MODEL: q8}, t8, w, None, 40.0)))
        vs_torch = b.assert_route_parity(
            got8, ref8, [lambda ids: b.exact_dense(emb, q8, ids),
                         lambda ids: b.exact_bm25_uniform(bm25, t8, self.DF,
                                                          ids)],
            [F32_ATOL, BM25_ATOL])
        self.shard_lists_vs_plain(sidx, q8, 32)

        self.retrieve_ms["A_sharded"] = p.cuda_event_ms(
            lambda: retr.retrieve_device(qd, terms, w, None, 40.0))
        self.retrieve_ms["A_unsharded"] = p.cuda_event_ms(
            lambda: flat.retrieve_device(qd, terms, w, None, 40.0))
        lists = [p.kernels.fused_dense_top_k(sh.dense[MODEL], q, 32)
                 for sh in sidx.shards]
        vals = [v for v, _ in lists]
        gids = [i + sh.offset for (_, i), sh in zip(lists, sidx.shards)]
        merge_ms = p.cuda_event_ms(
            lambda: p.gather_merge(vals, gids, 32, self.dev))
        kern, w1 = p.kernels, {MODEL: 1.0}
        dense_kw = dict(use_bm25=False, **kw)
        sharded_dense = p.ShardedRetriever(sidx, (MODEL,), **dense_kw)
        flat_dense = p.FusedRetriever(index, (MODEL,), **dense_kw)
        parts_ms = {
            "k1_whole": p.cuda_event_ms(
                lambda: kern.fused_dense_top_k(emb, q, 32)),
            "k1_each_shard": p.cuda_event_ms(lambda: [
                kern.fused_dense_top_k(sh.dense[MODEL], q, 32)
                for sh in sidx.shards]),
            "dense_only_sharded": p.cuda_event_ms(
                lambda: sharded_dense.retrieve_device(qd, None, w1, None,
                                                      40.0)),
            "dense_only_unsharded": p.cuda_event_ms(
                lambda: flat_dense.retrieve_device(qd, None, w1, None,
                                                   40.0)),
        }
        profile = {
            "sharded": self.device_profile(
                lambda: retr.retrieve_device(qd, terms, w, None, 40.0)),
            "unsharded": self.device_profile(
                lambda: flat.retrieve_device(qd, terms, w, None, 40.0)),
        }
        log(sharded="A", slots=self.N_SLOTS, n_local=sidx.n_local,
            shard_index_s=secs, shard_index_bytes=alloc,
            dense_ids_equal_k1=True, dense_max_abs_err=dense_err,
            k1_launches_per_call=counts["fused_dense_top_k"],
            recall10_hybrid=recall, vs_unsharded=vs_flat,
            b8_vs_torch_route=vs_torch,
            retrieve_ms=self.retrieve_ms["A_sharded"],
            unsharded_retrieve_ms=self.retrieve_ms["A_unsharded"],
            merge_ms=merge_ms, merge_shape=[q.shape[0], self.N_SLOTS, 32],
            parts_ms=parts_ms, profile=profile, card=self.card)
        return sidx, got, kw, w

    def phase19b_sharded(self, emb, q, bm25, terms_b) -> None:
        """Stage B's settings over N_SLOTS slots: a filter over half the
        docs and two-tier streaming BM25 per shard (K1 masked on every
        shard, and K1 on every shard's common tier)."""
        p, b = self.p, self.b
        n = emb.shape[0]
        sources = [("CG" if i % 2 == 0 else "NG") + str(i // 2)
                   for i in range(n)]
        index = self.make_index(emb, bm25, n, sources)
        sidx, secs, _ = self.shard_timed(lambda: p.shard_index(
            index, self.slot_mesh(self.N_SLOTS),
            two_tier_common=self.V_COMMON, two_tier_dtype="float32"))
        self.shard_seconds["B"] = secs
        assert all(m is not None for m in sidx.filter_mask("CG")[0])
        kw = dict(similarity_k=32, common_sections_n=32, budget=1024)
        w = {MODEL: 5.0, "BM25": 1.0}
        qd = {MODEL: q}
        retr = p.ShardedRetriever(sidx, (MODEL,), use_bm25=True,
                                  bm25_backend="two_tier_streaming", **kw)
        got, counts = self.main_path(
            lambda: retr.retrieve_lists(qd, terms_b, w, "CG", 40.0))
        self.expect("sharded B", counts,
                    fused_dense_top_k=2 * self.N_SLOTS)
        mask = index.filter_mask("CG")
        for ids in (got[0], got[2].reshape(-1, got[2].shape[-1])):
            live = ids[ids >= 0].long()
            assert bool(mask[live].all()), "an id outside the filter mask"
        flat = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                two_tier_common=self.V_COMMON,
                                two_tier_dtype="float32", **kw)
        assert flat._two_tier is not None
        routes = b.assert_route_parity(
            got, flat.retrieve_device(qd, terms_b, w, "CG", 40.0),
            [lambda ids: b.exact_dense(emb, q, ids),
             lambda ids: b.exact_bm25_uniform(bm25, terms_b, self.DF, ids)],
            [F32_ATOL, BM25_ATOL])
        log(sharded="B", slots=self.N_SLOTS, shard_index_s=secs,
            v_common_per_shard=self.V_COMMON,
            k1_launches_per_call=counts["fused_dense_top_k"],
            vs_unsharded_two_tier=routes,
            retrieve_ms=p.cuda_event_ms(
                lambda: retr.retrieve_device(qd, terms_b, w, "CG", 40.0)),
            card=self.card)

    def phase19e_recovery(self, sidx, got4, kw, w, emb, q, bm25, terms):
        """A dead slot: DeviceHealthMonitor reshards stage A over the
        survivors, whose fused ids stay those of the full mesh; then a
        dp = 2 x corpus = 2 mesh serving an odd batch through
        ShardedSearchEngine, ids equal to the dp = 1 mesh's."""
        p, b = self.p, self.b
        qd = {MODEL: q}
        state = {}
        dead = sidx.mesh.slots[2]
        mon = p.DeviceHealthMonitor(
            sidx, rebuild=lambda s: state.update(sidx=s),
            probe_fn=lambda slot, t: (slot is not dead
                                      and p.default_probe(slot, t)))
        t0 = time.perf_counter()
        assert mon.check_and_recover(), "no recovery ran"
        secs = time.perf_counter() - t0
        new = state["sidx"]
        assert new.n_shards == self.N_SLOTS - 1 and dead not in new.mesh.slots
        retr = p.ShardedRetriever(new, (MODEL,), use_bm25=True, **kw)
        got, counts = self.main_path(
            lambda: retr.retrieve_lists(qd, terms, w, None, 40.0))
        self.expect("recovered", counts, fused_dense_top_k=self.N_SLOTS - 1)
        routes = b.assert_route_parity(
            got, got4, [lambda ids: b.exact_dense(emb, q, ids),
                        lambda ids: b.exact_bm25_uniform(bm25, terms,
                                                         self.DF, ids)],
            [F32_ATOL, BM25_ATOL])
        events = [{k: v for k, v in e.items() if k != "ts"}
                  for e in mon.events]
        del state, new, retr, mon

        index, tokens = self.stage_a_reference_index(emb, bm25, terms)
        odd = self.DP_ODD_B
        kw_e = dict(query_token_lists=tokens[:odd], similarity_k=32,
                    common_sections_n=15, model_weights=w,
                    use_hybrid_search=True)
        out, q_odd = {}, q[:odd].cpu().numpy()
        for dp in (1, 2):
            # Two corpus slots in each dp group: the same shards, so the
            # same ids; the odd batch is padded to the dp axis.
            eng = p.ShardedSearchEngine(p.shard_index(
                index, self.slot_mesh(2 * dp, dp=dp)))
            out[dp], c_dp = self.main_path(
                lambda: eng.retrieve({MODEL: q_odd}, **kw_e))
            self.expect(f"engine dp={dp}", c_dp, fused_dense_top_k=2 * dp)
            assert len(out[dp]) == odd
        if out[1] != out[2]:
            raise AssertionError("dp = 2 ids differ from dp = 1's")
        log(sharded="E_recovery", dead_slot=dead.index,
            survivors=self.N_SLOTS - 1, recovery_s=secs, events=events,
            k1_launches_per_call=counts["fused_dense_top_k"],
            vs_full_mesh=routes, dp2_odd_batch=odd, dp2_ids_equal_dp1=True,
            card=self.card)
        return index, tokens

    def phase19f_rag(self, index, tokens, gold, q) -> None:
        """ShardedSearchEngine under RAGSystem on stage A's index: the
        answers streamed, the planted gold among each one's sources."""
        p = self.p
        sse = p.ShardedSearchEngine(
            p.shard_index(index, self.slot_mesh(self.N_SLOTS)))
        system = p.RAGSystem(indexes={},
                             llm_clients={"fake": p.FakeLLMClient()},
                             device=self.dev)
        system.attach_index(p.InfoSource.NICE, index, engine=sse)
        w = {MODEL: 5.0, "BM25": 1.0}
        q_host = q.cpu().numpy()
        gold_ids = [str(g) for g in gold.tolist()]

        def answers():
            out = []
            for i in range(self.RAG_QUERIES):
                out.append(list(system.query_rag_stream(
                    " ".join(tokens[i]), "fake-llm", model_weights=w,
                    use_hybrid_search=True, use_reranker=False,
                    filename_type_filter=None,
                    query_embedding={MODEL: q_host[i]})))
                out[-1].append(system.last_trace.durations["retrieval"])
            return out

        runs, counts = self.main_path(answers)
        self.expect("sharded RAG", counts,
                    fused_dense_top_k=self.RAG_QUERIES * self.N_SLOTS)
        spans = []
        for i, out in enumerate(runs):
            spans.append(out.pop())
            answer = "".join(t[0] for t in out)
            if not answer.startswith("[fake:fake-llm]"):
                raise AssertionError(f"answer {answer[:80]!r}")
            sections = [d["section_id"] for d in out[-1][3]]
            if gold_ids[i] not in sections:
                raise AssertionError(f"sharded RAG query {i}: gold "
                                     f"{gold_ids[i]} not in {sections}")
        log(sharded="F_rag", slots=self.N_SLOTS, queries=len(runs),
            gold_in_sources=len(runs),
            k1_launches=counts["fused_dense_top_k"],
            retrieval_span_median_ms=statistics.median(spans) * 1e3,
            card=self.card)

    def phase19c_sharded(self, index, q, gold) -> None:
        """Stage C's int8 matrix over N_SLOTS slots (views, no copy): K2
        per shard against unsharded K2, each shard's list equal to its
        plain version, and the times beside the unsharded ones."""
        p, b = self.p, self.b
        qd = index.dense_q[MODEL]
        sidx, secs, alloc = self.shard_timed(
            lambda: p.shard_index(index, self.slot_mesh(self.N_SLOTS)))
        self.shard_seconds["C"] = secs
        views = all(sh.dense[MODEL].values.data_ptr()
                    == qd.values[sh.offset:].data_ptr()
                    for sh in sidx.shards)
        assert views, "stage C's shards must be views of its matrix"
        retr = p.ShardedRetriever(sidx, (MODEL,), use_bm25=False,
                                  similarity_k=25, common_sections_n=25)
        assert retr.use_kernel
        w = {MODEL: 1.0}
        (fids, _, _), counts = self.main_path(
            lambda: retr.retrieve_device({MODEL: q}, None, w, None, 40.0))
        self.expect("sharded C", counts,
                    fused_dense_top_k_int8=self.N_SLOTS)
        recall = b.recall_at_10(fids, gold)
        assert recall >= 0.95, f"sharded int8 recall@10 {recall} < 0.95"
        (sv, si), c_dense = self.main_path(
            lambda: p.sharded_dense_top_k(sidx, MODEL, q, 25))
        self.expect("sharded C, dense", c_dense,
                    fused_dense_top_k_int8=self.N_SLOTS)
        qv, qs = p.quantize_queries(q)
        kv, ki = p.kernels.fused_dense_top_k_int8(qd.values, qd.scales, qv,
                                                  qs, 25)
        torch.cuda.synchronize()
        swaps = p.check_top_k(kv, ki, sv, si, INT8_ATOL)
        if not torch.equal(fids, si):
            raise AssertionError("retriever ids differ from the merge's")
        qv8, qs8 = p.quantize_queries(q[:8])
        kern = p.kernels
        for sh in sidx.shards:
            m = sh.dense[MODEL]
            args = (m.values, m.scales, qv8, qs8, 25)
            self.equal_int8(kern.fused_dense_top_k_int8(*args),
                            kern.fused_dense_top_k_int8_torch(*args),
                            f"shard at {sh.offset}")
        flat = p.FusedRetriever(index, (MODEL,), use_bm25=False,
                                similarity_k=25, common_sections_n=25)
        self.retrieve_ms["C_sharded"] = p.cuda_event_ms(
            lambda: retr.retrieve_device({MODEL: q}, None, w, None, 40.0))
        self.retrieve_ms["C_unsharded"] = p.cuda_event_ms(
            lambda: flat.retrieve_device({MODEL: q}, None, w, None, 40.0))
        parts_ms = {
            "k2_whole": p.cuda_event_ms(lambda: kern.fused_dense_top_k_int8(
                qd.values, qd.scales, qv, qs, 25)),
            "k2_each_shard": p.cuda_event_ms(lambda: [
                kern.fused_dense_top_k_int8(sh.dense[MODEL].values,
                                            sh.dense[MODEL].scales, qv, qs,
                                            25) for sh in sidx.shards]),
        }
        log(sharded="C", slots=self.N_SLOTS, n_local=sidx.n_local,
            shard_index_s=secs, shard_index_bytes=alloc, shards_are_views=True,
            k2_launches_per_call=counts["fused_dense_top_k_int8"],
            recall10=recall, vs_unsharded_k2_swaps=swaps,
            vs_unsharded_atol=INT8_ATOL, shard_lists_equal_plain_b8=True,
            retrieve_ms=self.retrieve_ms["C_sharded"],
            unsharded_retrieve_ms=self.retrieve_ms["C_unsharded"],
            parts_ms=parts_ms, card=self.card)

    def shard_ivf_vs_plain(self, sidx, q8) -> None:
        """Each shard's K3 (or K4) over its own tile table against the
        plain version."""
        p, kern = self.p, self.p.kernels
        for sh in sidx.shards:
            iv = sh.ivf
            table, _ = p.build_tile_table(
                iv.centroids, iv.cluster_start, q8,
                nprobe=self.NPROBE_SHARDED,
                max_tiles=p.default_max_tiles(iv, q8.shape[0],
                                              self.NPROBE_SHARDED),
                tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
            table = torch.cat([table, sh.ivf_real_slot])
            kw = dict(tile_n=iv.tile_n, n_real=0)
            if iv.emb is not None:
                self.compare(
                    "ivf_dense_top_k",
                    kern.ivf_dense_top_k_torch(iv.emb, q8, table, self.K_D,
                                               **kw),
                    kern.ivf_dense_top_k(iv.emb, q8, table, self.K_D, **kw),
                    BF16_ATOL)
            else:
                qv, qs = p.quantize_queries(q8)
                args = (iv.values, iv.scales, qv, qs, table, self.K_D)
                self.equal_int8(kern.ivf_dense_top_k_int8(*args, **kw),
                                kern.ivf_dense_top_k_int8_torch(*args, **kw),
                                f"K4 on the shard at {sh.offset}")

    def ivf_batches(self, retr, q):
        """retrieve_device over BATCHES_D micro-batches of B_MICRO."""
        bm, w = self.B_MICRO, {MODEL: 1.0}
        return torch.cat([
            retr.retrieve_device({MODEL: q[i * bm:(i + 1) * bm]}, None, w,
                                 None, 40.0)[0]
            for i in range(self.BATCHES_D)])

    def phase19d_sharded_ivf(self, index, q, gold) -> None:
        """Stage D's corpus with a per-shard IVF: per-shard k-means, K3 per
        shard at B = 8, a full probe against the exact route, the saved
        clustering loaded again and into the int8 copy of the corpus (K4
        per shard)."""
        p, b = self.p, self.b
        emb = index.dense[MODEL]
        n = emb.shape[0]
        mesh = self.slot_mesh(self.N_SLOTS)
        sidx = p.shard_index(index, mesh)
        sidx, secs, alloc = self.shard_timed(lambda: p.shard_ivf(
            sidx, MODEL, tile_n=self.TILE_D, n_iters=10, seed=0))
        self.shard_seconds["D_ivf"] = secs
        c = sidx.ivf_n_clusters
        kw = dict(use_bm25=False, similarity_k=self.K_D,
                  common_sections_n=self.K_D)
        retr = p.ShardedRetriever(sidx, (MODEL,), nprobe=self.NPROBE_SHARDED,
                                  **kw)
        assert retr._route_ivf(self.B_MICRO, False, False)
        ids, counts = self.main_path(lambda: self.ivf_batches(retr, q))
        self.expect("sharded D", counts, fused_dense_top_k=0,
                    ivf_dense_top_k=self.BATCHES_D * self.N_SLOTS)
        recall = b.recall_at_10(ids, gold)
        assert recall >= 0.90, f"sharded IVF recall@10 {recall} < 0.90"
        q8, w = q[:self.B_MICRO], {MODEL: 1.0}
        self.shard_ivf_vs_plain(sidx, q8)

        full = p.ShardedRetriever(sidx, (MODEL,), nprobe=c,
                                  ivf_route="always", **kw)
        exact = p.ShardedRetriever(sidx, (MODEL,), **kw)
        got, c_full = self.main_path(
            lambda: full.retrieve_device({MODEL: q8}, None, w, None, 40.0))
        self.expect("sharded D, full probe", c_full, fused_dense_top_k=0,
                    ivf_dense_top_k=self.N_SLOTS)
        ref = exact.retrieve_device({MODEL: q8}, None, w, None, 40.0)
        torch.cuda.synchronize()
        if not torch.equal(got[0], ref[0]):
            raise AssertionError("full probe ids differ from the exact "
                                 "sharded route's")

        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "shard_ivf.npz")
            p.save_shard_ivf(sidx, path)
            back = p.load_shard_ivf(p.shard_index(index, mesh), path)
            again = p.ShardedRetriever(back, (MODEL,),
                                       nprobe=self.NPROBE_SHARDED, **kw)
            if not torch.equal(self.ivf_batches(again, q), ids):
                raise AssertionError("the loaded IVF's ids differ")
            del back, again
            qindex = self.b.array_index(n, dense_q={
                MODEL: p.quantize_embeddings(emb)})
            qsidx = p.load_shard_ivf(p.shard_index(qindex, mesh), path)
        qretr = p.ShardedRetriever(qsidx, (MODEL,),
                                   nprobe=self.NPROBE_SHARDED, **kw)
        q_ids, q_counts = self.main_path(lambda: self.ivf_batches(qretr, q))
        self.expect("sharded D, int8", q_counts,
                    ivf_dense_top_k_int8=self.BATCHES_D * self.N_SLOTS)
        q_recall = b.recall_at_10(q_ids, gold)
        assert q_recall >= 0.90, f"sharded int8 IVF recall {q_recall}"
        self.shard_ivf_vs_plain(qsidx, q8)
        log(sharded="D_ivf", slots=self.N_SLOTS, n_local=sidx.n_local,
            clusters_per_shard=c, tile_n=self.TILE_D,
            nprobe=self.NPROBE_SHARDED, shard_ivf_s=secs,
            shard_ivf_bytes=alloc, calls_b8=self.BATCHES_D,
            k3_launches=counts["ivf_dense_top_k"], recall10_b8=recall,
            full_probe_ids_equal_exact=True, saved_loaded_ids_equal=True,
            k4_launches=q_counts["ivf_dense_top_k_int8"],
            recall10_int8_b8=q_recall,
            retrieve_ms_b8=p.cuda_event_ms(lambda: retr.retrieve_device(
                {MODEL: q8}, None, w, None, 40.0)),
            card=self.card)

    def sharded_part(self, name, fn, *args):
        """Run one part of phase 19, keeping its seconds and the card's
        peak allocation during it."""
        return self.part(self.sharded_parts, name, fn, *args)

    def served_part(self, name, fn, *args):
        """The same for a part of phase 20."""
        return self.part(self.served_parts, name, fn, *args)

    @staticmethod
    def part(parts, name, fn, *args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        parts[name] = {"seconds": time.perf_counter() - t0,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        return out

    def phase19_summary(self) -> None:
        log(phase="sharded", slots=self.N_SLOTS, parts=self.sharded_parts,
            seconds=sum(v["seconds"] for v in self.sharded_parts.values()),
            shard_seconds=self.shard_seconds, retrieve_ms={
                k: v for k, v in self.retrieve_ms.items() if "sharded" in k},
            card=self.card,
            method="retrieve_ms: CUDA events around one call, median of 10 "
            "after 3 warm-up calls")

    # -- phase 20: the served path ------------------------------------------

    def served_front(self, name, connect, counters, per=None):
        """Drive one front (``connect`` for bench.drive_front) as a path of
        its own: SERVED_CLIENTS clients, SERVED_ROUNDS rounds of ``per``
        requests; its K1 / K3 launches against its device batches
        (``counters()``: (batches, rows) served so far)."""
        b0, r0 = counters()
        stats, counts = self.main_path(lambda: self.b.drive_front(
            connect, self.SERVED_CLIENTS, self.SERVED_ROUNDS,
            per or self.SERVED_PER, self.B))
        b1, r1 = counters()
        batches = b1 - b0
        k1 = counts["fused_dense_top_k"]
        if k1 < batches or not batches:
            raise AssertionError(f"{name}: K1 {k1} launches for {batches} "
                                 "device batches")
        stats.update(device_batches=batches, mean_device_batch=(
            (r1 - r0) / batches), k1_launches=k1)
        self.served_fronts[name] = stats
        return stats

    @staticmethod
    def pool_counters(state):
        def read():
            scheds = list(state.pool._pool.values())
            return (sum(x.batches_run for x in scheds),
                    sum(x.queries_served for x in scheds))
        return read

    def frames(self, q_host, t_host, ids):
        """Per client a rotation of the batch's rows: (queries, terms, the
        direct call's ids) of client r."""
        counter = itertools.count()

        def next_frame():
            r = next(counter) % self.SERVED_CLIENTS
            shift = r * max(1, self.B // self.SERVED_CLIENTS)
            return (np.roll(q_host, shift, 0), np.roll(t_host, shift, 0),
                    np.roll(ids, shift, 0), shift)
        return next_frame

    def phase20a_served(self, emb, gold, q, bm25, terms):
        """Stage A's index behind build_state / serve_state with the tuned
        K1 plan: the HTTP b64 RPC in f32 and bf16 and the native front's
        three wires at 256-row frames, every f32 / bf16 reply equal to a
        direct retrieve_device on its rows, the int8 wire's planted
        recall; then single-query JSON and 8-row frames for latency."""
        p, b = self.p, self.b
        index, tokens = self.stage_a_reference_index(emb, bm25, terms)
        w = {MODEL: 5.0, "BM25": 1.0}
        t0 = time.perf_counter()
        state = p.build_state(
            index, (MODEL,), use_bm25=True, autotune=True, similarity_k=32,
            common_sections_n=15, budget=1024, scheduler_kwargs={
                "max_batch": 2 * self.B, "max_wait_ms": 2.0,
                "max_inflight": 4})
        build_s = time.perf_counter() - t0
        retr = state.retriever
        assert retr.use_kernel, "the 2M index must serve through K1"
        cfg = retr.kernel_config
        # The tuned plan spreads the work only: K1's output at the served
        # shapes equals the default plan's.
        k = p.kernels
        q2 = torch.cat([q, q.flip(1)])  # the tuned batch, 2B rows
        batches = [1, self.B_MICRO, self.B, 2 * self.B]
        for bb in batches:
            ref = k.fused_dense_top_k(emb, q2[:bb], 32)
            got = k.fused_dense_top_k(emb, q2[:bb], 32, plan=cfg)
            torch.cuda.synchronize()
            if not (torch.equal(ref[0], got[0])
                    and torch.equal(ref[1], got[1])):
                raise AssertionError(f"tuned plan {cfg} changed K1's output "
                                     f"at B={bb}")
        plan_ms = {f"{label}_b{bb}": p.cuda_event_ms(
            lambda: k.fused_dense_top_k(emb, q2[:bb], 32, plan=plan))
            for bb in (self.B, 2 * self.B)
            for label, plan in (("tuned", cfg), ("default", None))}
        q_host, t_host = q.cpu().numpy(), terms.cpu().numpy()
        gold_h = gold.cpu().numpy()
        qd = {MODEL: q}
        want = retr.retrieve_device(qd, terms, w, None, 40.0)[0].cpu().numpy()
        q_bf = p.bf16_values(p.bf16_bits(q_host))
        want_bf = retr.retrieve_device({MODEL: torch.as_tensor(
            q_bf, device=self.dev)}, terms, w, None, 40.0)[0].cpu().numpy()
        log(served="A_plan", kernel_config=cfg and cfg._asdict(),
            build_state_s=build_s, k1_ms=plan_ms,
            k1_equal_default_plan_at_b=batches, card=self.card,
            method="CUDA events, median of 10 after 3 warm-ups; the tuned "
            "plan applies at its batch only")

        server = p.serve_state(state, w, port=0, background=True)
        try:
            port = server.server_address[1]
            self.served_http(state, port, q_host, t_host, want, w, "f32")
            self.served_http(state, port, q_bf, t_host, want_bf, w, "bf16")
            self.served_latency(state, port, q_host, t_host, want, index)
        finally:
            server.shutdown()
        recall, rows = self.served_native(state, w, q_host, t_host, want,
                                          want_bf, gold_h)
        overlap = b.overlap_at(rows["int8"], rows["f32"])
        log(served="A_native_int8", recall10_min=recall,
            overlap10_vs_f32=overlap, card=self.card)
        del state, retr
        return want, index, tokens

    def served_http(self, state, port, q_host, t_host, want, w, dtype):
        b = self.b
        next_frame = self.frames(q_host, t_host, want)

        def connect():
            qf, tf, wf, _ = next_frame()
            conn = b.HttpSender(port, b.b64_body(qf, tf, w, dtype))
            return b.Sending(conn, conn, lambda got: _equal_ids(
                got, wf, f"HTTP b64 {dtype}"))

        self.served_front(f"http_b64_{dtype}", connect,
                          self.pool_counters(state))

    def served_native(self, state, w, q_host, t_host, want, want_bf, gold):
        """The native front's f32, bf16 and int8 wires; per wire its
        first reply of each rotation kept for the overlap."""
        p = self.p
        rows, recall = {}, [1.0]
        for wire in ("f32", "bf16", "int8"):
            front = p.NativeRetrievalFront(
                state.retriever, w, port=0, t_max=self.T,
                max_batch=2 * self.B, wait_ms=2.0, wire_dtype=wire)
            try:
                ref = want_bf if wire == "bf16" else want
                next_frame = self.frames(q_host, t_host, ref)

                def connect(wire=wire, port=front.port):
                    qf, tf, wf, shift = next_frame()
                    if wire == "bf16":  # rounded once, sent as bits
                        qf = p.bf16_bits(qf)
                    cl = p.NativeFrontClient("127.0.0.1", port,
                                             wire_dtype=wire)

                    def check(got):
                        if wire == "int8":
                            g = np.roll(gold, shift, 0)
                            r = float((got[:, :10] == g[:, None]).any(
                                1).mean())
                            recall.append(r)
                            if r < 0.99:
                                raise AssertionError(
                                    f"int8 wire recall@10 {r} below 0.99")
                            rows.setdefault(wire, np.roll(got, -shift, 0))
                        else:
                            _equal_ids(got, wf, f"native {wire}")
                            rows.setdefault(wire, np.roll(got, -shift, 0))
                    return self.b.Sending(cl, lambda: cl.search(qf, tf)[0],
                                          check)

                with connect() as send:  # warm the front's threads
                    send()
                self.served_front(
                    f"native_{wire}", connect,
                    lambda: (front.batches_run, front.rows_served))
            finally:
                front.stop()
        return min(recall), rows

    def served_latency(self, state, port, q_host, t_host, want, index):
        """One client in turn: single-query JSON /v1/search (B = 1) and
        8-row b64 frames, each reply's ids equal to the direct call's,
        held to SERVED_LIMITS_MS. Beside them, the same rows through the
        layers below HTTP: the scheduler pool (submit_sync /
        submit_batch_sync, from this thread) and a direct retrieve_device
        with its upload and download, as the scheduler makes them."""
        b, bm = self.b, self.B_MICRO
        w = {MODEL: 5.0, "BM25": 1.0}
        ids_of = index.meta.ids
        counters = self.pool_counters(state)
        retr = state.retriever

        def start(i, bb):
            return (i * bb) % (self.B - bb + 1)

        def single(sender, i):
            r = i % self.B
            sender.body = json.dumps({"query_embedding": q_host[r].tolist(),
                                      "terms": t_host[r].tolist()})
            got = [x["id"] for x in sender.post()["results"]]
            if got != [ids_of[j] for j in want[r] if j >= 0]:
                raise AssertionError(f"single query {r}: {got[:3]}")

        def frame8(sender, i):
            r0 = start(i, bm)
            sender.body = b.b64_body(q_host[r0:r0 + bm], t_host[r0:r0 + bm],
                                     w)
            _equal_ids(sender(), want[r0:r0 + bm], "8-row frame")

        def pool(bb):
            def one(_, i):
                r0 = start(i, bb)
                if bb == 1:
                    got = state.submit_sync({MODEL: q_host[r0]}, t_host[r0],
                                            w, None, 40.0)[0][None]
                else:
                    got = state.submit_batch_sync(
                        MODEL, q_host[r0:r0 + bb], t_host[r0:r0 + bb], w,
                        None, 40.0)[0]
                _equal_ids(got, want[r0:r0 + bb], f"pool B={bb}")
            return one

        def direct(bb):
            def one(_, i):
                r0 = start(i, bb)
                ids, vals, _ = retr.retrieve_device(
                    {MODEL: q_host[r0:r0 + bb]}, t_host[r0:r0 + bb], w,
                    None, 40.0)
                got = ids.cpu().numpy()
                vals.cpu()
                _equal_ids(got, want[r0:r0 + bb], f"direct B={bb}")
            return one

        def timed(name, one, sender, pooled):
            lat = []

            def run():
                for i in range(self.SERVED_LATENCY):
                    t0 = time.perf_counter()
                    one(sender, i)
                    lat.append((time.perf_counter() - t0) * 1e3)

            b0, n0 = counters()
            _, counts = self.main_path(run)
            b1, n1 = counters()
            k1 = counts["fused_dense_top_k"]
            batches = b1 - b0 if pooled else self.SERVED_LATENCY
            if k1 < batches or not batches:
                raise AssertionError(f"{name}: K1 {counts} for {batches} "
                                     "batches")
            out = {"p50_ms": float(np.percentile(lat, 50)),
                   "p99_ms": float(np.percentile(lat, 99)),
                   "requests": len(lat), "k1_launches": k1}
            if pooled:
                out["mean_device_batch"] = (n1 - n0) / batches
            return out

        layers = {}
        for bb in (1, bm):
            layers[f"direct_b{bb}"] = timed(f"direct B={bb}", direct(bb),
                                            None, False)
            layers[f"pool_b{bb}"] = timed(f"pool B={bb}", pool(bb), None,
                                          True)
        with b.HttpSender(port, "") as sender:
            for name, one in (("json_b1", single), ("b64_b8", frame8)):
                self.served_latency_ms[name] = timed(name, one, sender, True)
        self.served_layers_ms = layers
        log(served="A_latency", **self.served_latency_ms, layers=layers,
            card=self.card, limits_ms=self.SERVED_LIMITS_MS,
            method="host clock around one request and its reply, one "
            "client in turn; layers: the same rows through the scheduler "
            "pool and through a direct retrieve_device with its upload and "
            "download")
        over = over_limits(self.served_latency_ms, self.SERVED_LIMITS_MS)
        if over:
            raise AssertionError(f"served latency over its limit: {over}")

    def phase20b_served_ivf(self, index, q, gold) -> None:
        """Stage D's corpus served in 8-row frames with no coalescing
        (max_batch 8, max_wait_ms 0), dense only, k 16: the IVF route
        (nprobe 16, K3) and the exact route (nprobe 0, K1), one client in
        turn; recall@10 of the IVF replies, their lists held against the
        direct call's by exact rescoring, and the p50 / p99 of each."""
        p, b = self.p, self.b
        bm, nb = self.B_MICRO, self.BATCHES_D
        emb = index.dense[MODEL]
        q_host = q.cpu().numpy()
        w = {MODEL: 1.0}
        out = {}
        for route, nprobe in (("ivf", self.NPROBE_D), ("exact", 0)):
            state = p.build_state(
                index, (MODEL,), use_bm25=False, nprobe=nprobe,
                similarity_k=self.K_D, common_sections_n=self.K_D,
                scheduler_kwargs={"max_batch": bm, "max_wait_ms": 0.0,
                                  "max_inflight": 1})
            server = p.serve_state(state, w, port=0, background=True)
            got, lat = [], []
            try:
                with b.HttpSender(server.server_address[1], "") as sender:
                    def run():
                        for i in range(nb):
                            sender.body = b.b64_body(
                                q_host[i * bm:(i + 1) * bm], None, w)
                            t0 = time.perf_counter()
                            got.append(sender())
                            lat.append((time.perf_counter() - t0) * 1e3)

                    b0 = self.pool_counters(state)()[0]
                    _, counts = self.main_path(run)
                    batches = self.pool_counters(state)()[0] - b0
            finally:
                server.shutdown()
            ids = torch.as_tensor(np.concatenate(got), device=self.dev)
            direct = torch.cat([state.retriever.retrieve_device(
                {MODEL: q[i * bm:(i + 1) * bm]}, None, w, None, 40.0)[0]
                for i in range(nb)])
            swaps = p.check_top_k(b.exact_dense(emb, q, direct), direct,
                                  b.exact_dense(emb, q, ids), ids,
                                  FULL_PROBE_ATOL)
            kernel = "ivf_dense_top_k" if nprobe else "fused_dense_top_k"
            if counts[kernel] < batches or batches != nb:
                raise AssertionError(f"served {route}: {counts} for "
                                     f"{batches} batches")
            out[route] = {
                "recall10": b.recall_at_10(ids, gold),
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "batches": batches, "launches": counts[kernel],
                "kernel": kernel, "swaps_vs_direct": swaps}
            del state
        if out["ivf"]["recall10"] < 0.90:
            raise AssertionError(f"served IVF recall@10 "
                                 f"{out['ivf']['recall10']} below 0.90")
        if out["ivf"]["launches"] < 1:
            raise AssertionError("the served IVF route launched no K3")
        self.served_latency_ms["ivf_b8"] = out["ivf"]
        self.served_latency_ms["exact_b8"] = out["exact"]
        log(served="B_ivf_b8", nprobe=self.NPROBE_D, batch=bm, frames=nb,
            **out, card=self.card)

    def phase20c_served_sharded(self, index, q, terms, want):
        """Stage A's index over 4 slots of the card behind build_state:
        slot 3 killed through the monitor's probe, check_and_recover swaps
        the retriever and the pool live; the served fused ids before and
        after equal the unsharded served ids."""
        p, b = self.p, self.b
        w = {MODEL: 5.0, "BM25": 1.0}
        state = p.build_state(
            index, (MODEL,), use_bm25=True, shards=self.N_SLOTS,
            devices=[self.dev] * self.N_SLOTS, similarity_k=32,
            common_sections_n=15, budget=1024,
            scheduler_kwargs={"max_batch": 2 * self.B, "max_wait_ms": 2.0})
        dead = set()
        state.monitor.probe_fn = lambda slot, t: (
            slot not in dead and p.default_probe(slot, t))
        body = b.b64_body(q.cpu().numpy(), terms.cpu().numpy(), w)
        server = p.serve_state(state, w, port=0, background=True)
        launches = []
        try:
            with b.HttpSender(server.server_address[1], body) as send:
                for when in ("before", "after"):
                    if when == "after":
                        old_pool = state.pool
                        dead.add(state.retriever.sidx.mesh.slots[3])
                        if not state.monitor.check_and_recover():
                            raise AssertionError("no recovery ran")
                        if state.pool is old_pool:
                            raise AssertionError("the pool was not swapped")
                    got, counts = self.main_path(send)
                    _equal_ids(got, want, f"sharded served {when}")
                    launches.append(counts["fused_dense_top_k"])
        finally:
            server.shutdown()
        shards = state.retriever.sidx.n_shards
        if launches != [self.N_SLOTS, self.N_SLOTS - 1] or \
                shards != self.N_SLOTS - 1:
            raise AssertionError(f"K1 launches {launches}, {shards} shards")
        events = [{k: v for k, v in e.items() if k != "ts"}
                  for e in state.monitor.events]
        log(served="C_sharded_swap", slots=self.N_SLOTS, dead_slot=3,
            shards_after=shards, k1_launches_per_batch=launches,
            ids_equal_unsharded=True, events=events, card=self.card)

    def phase20d_served_rag(self, index, tokens, gold, q) -> None:
        """http_api.serve over RAGSystem on stage A's index: /v1/search and
        /v1/rag (JSON and SSE) with the planted gold among the sources,
        /v1/feedback, the UI and /v1/embeddings (PrecomputedEmbedder)."""
        p = self.p
        import urllib.request
        n_q = self.RAG_QUERIES
        texts = [" ".join(tokens[i]) for i in range(n_q)]
        q_host = q.cpu().numpy()
        table = {t: q_host[i] for i, t in enumerate(texts)}
        gold_ids = [str(g) for g in gold.tolist()]
        w = {MODEL: 5.0, "BM25": 1.0}
        system = p.RAGSystem(indexes={p.InfoSource.NICE: index},
                             embedder=p.PrecomputedEmbedder(table),
                             llm_clients={"fake": p.FakeLLMClient()},
                             device=self.dev)
        with tempfile.TemporaryDirectory() as tmp:
            fb = p.FeedbackLog(str(Path(tmp) / "feedback.json"))
            server = p.http_serve(system, port=0, background=True,
                                  feedback_log=fb)
            port = server.server_address[1]

            def post(path, payload, raw=False):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}{path}",
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    data = resp.read()
                return data.decode() if raw else json.loads(data)

            def run():
                out = {"search": 0, "rag": 0, "rag_sse": 0}
                for i, text in enumerate(texts):
                    kw = {"query": text, "model_weights": w,
                          "use_hybrid_search": True, "similarity_k": 32,
                          "common_sections_n": 15, "llm_model": "fake-llm",
                          "use_reranker": False}
                    found = post("/v1/search", kw)["results"]
                    out["search"] += gold_ids[i] in [d["id"] for d in found]
                    rag = post("/v1/rag", kw)
                    if not rag["answer"].startswith("[fake:fake-llm]"):
                        raise AssertionError(rag["answer"][:80])
                    out["rag"] += gold_ids[i] in [
                        s["section_id"] for s in rag["sources"]]
                    sse = post("/v1/rag", dict(kw, stream=True), raw=True)
                    events = [ln[6:] for ln in sse.splitlines()
                              if ln.startswith("data: ")]
                    if events[-1] != "[DONE]" or len(events) < 3:
                        raise AssertionError(f"SSE events {events[:3]}")
                    srcs = json.loads(events[0])["sources"]
                    out["rag_sse"] += gold_ids[i] in [
                        s["section_id"] for s in srcs]
                return out

            try:
                found = self.no_kernels("served RAG", run)
                rec = post("/v1/feedback", {"query": texts[0],
                                            "rating": "up",
                                            "response": "r"})
                emb = post("/v1/embeddings", {"input": texts[:2]})
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                            timeout=60) as resp:
                    html = resp.read().decode()
            finally:
                server.shutdown()
            if any(v != n_q for v in found.values()):
                raise AssertionError(f"gold among the sources: {found}")
            if rec["status"] != "recorded" or len(fb.entries()) != 1:
                raise AssertionError(f"feedback {rec}")
            vecs = np.asarray([d["embedding"] for d in emb["data"]],
                              np.float32)
            if not np.array_equal(vecs, q_host[:2]):
                raise AssertionError("/v1/embeddings rows differ")
            if "NICE Guidelines RAG" not in html or "v1/rag/stream" \
                    not in html:
                raise AssertionError("the UI page is not the chat page")
        log(served="D_rag_surface", n=index.n_docs, queries=n_q,
            gold_in_search=found["search"], gold_in_rag=found["rag"],
            gold_in_rag_sse=found["rag_sse"], feedback_recorded=True,
            embeddings_equal_table=True, ui_page=True, card=self.card)
        del system

    def served_summary(self) -> None:
        log(phase="served", parts=self.served_parts,
            seconds=sum(v["seconds"] for v in self.served_parts.values()),
            fronts=self.served_fronts, latency=self.served_latency_ms,
            latency_layers=self.served_layers_ms, card=self.card,
            method="QPS: rows over each round's wall time (clients x "
            "requests of one frame), min / median / max over the rounds; "
            "ms: host clock around each request and its reply")

    # -- phase 21: the models ----------------------------------------------

    def models_part(self, name, fn, *args):
        """Run one part of phase 21, its K1 launches counted in the summary
        line through the main path's totals."""
        k1 = self.main_launches["fused_dense_top_k"]
        out = self.part(self.models_parts, name, fn, *args)
        self.models_parts[name]["k1_launches"] = (
            self.main_launches["fused_dense_top_k"] - k1)
        self.models_k1 += self.models_parts[name]["k1_launches"]
        return out

    def qwen3_batch(self, vocab):
        """QWEN3_B rows of QWEN3_S ids: mixed lengths (row 0 whole, row 1
        one token), even rows right-padded and odd rows left-padded; -1 is
        padding (Qwen3Encoder's mask is ids >= 0)."""
        b, s, dev = self.QWEN3_B, self.QWEN3_S, self.dev
        g = self.seed(2101)
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        lengths[0], lengths[1] = s, 1
        ids = torch.randint(0, vocab, (b, s), generator=g, device=dev)
        pos = torch.arange(s, device=dev)[None]
        mask = torch.where((torch.arange(b, device=dev) % 2 == 0)[:, None],
                           pos < lengths[:, None],
                           pos >= s - lengths[:, None])
        return torch.where(mask, ids, -1), mask

    @staticmethod
    def cpu_state(module):
        return {k: v.detach().float().cpu()
                for k, v in module.state_dict().items()}

    def phase21a_qwen3(self) -> None:
        """Qwen3 at Qwen3-Embedding-0.6B's widths, bf16 weights on the
        card: B x S ids embedded (last-token pool, unit norm), timed, held
        against the CPU's float32 forward of the same weights on
        QWEN3_CPU_ROWS rows (cosine) and, at QWEN3_CUT layers, float32 on
        the card against float32 on the CPU (max abs); then the vectors
        through FusedRetriever.retrieve_device over an N_MODELS x hidden
        bf16 index with BM25 (K1), its dense list held against K1's plain
        version."""
        p, k = self.p, self.p.kernels
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on: float32 products would not "
                                 "be float32")
        cfg = p.Qwen3Config(dtype=torch.bfloat16, **self.QWEN3)
        d, r = cfg.hidden_size, self.QWEN3_CPU_ROWS
        t0 = time.perf_counter()
        enc = p.init_qwen3(cfg, seed=21, device=self.dev,
                           param_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in enc.parameters())
        weight_gib = sum(x.numel() * x.element_size()
                         for x in enc.parameters()) / 2**30
        non_emb = n_params - cfg.vocab_size * d
        ids, mask = self.qwen3_batch(cfg.vocab_size)

        def forward(m=enc, x=ids):
            with torch.inference_mode():
                return m(x)

        out = forward()
        torch.cuda.synchronize()
        forward_ms = p.cuda_event_ms(forward)
        profile = self.device_profile(forward)
        profile["top_kernels"] = p.profiled_top_kernels(forward)
        tokens = ids.numel()
        flop = 2 * non_emb * tokens
        attn_flop = (4 * self.QWEN3_B * self.QWEN3_S ** 2 * cfg.num_heads
                     * cfg.head_dim * cfg.num_layers)
        if tuple(out.shape) != (self.QWEN3_B, d) or out.dtype != \
                torch.float32 or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"Qwen3 output {tuple(out.shape)} "
                                 f"{out.dtype}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        unit_err = float((out.norm(dim=-1) - 1).abs().max())
        if unit_err > self.UNIT_TOL:
            raise AssertionError(f"Qwen3 embedding norms off by {unit_err}")

        t0 = time.perf_counter()
        sd = self.cpu_state(enc)
        del enc
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        ids_h = ids[:r].cpu()
        want = forward(p.load_qwen3_state(cfg32, sd, device="cpu"), ids_h)
        cpu_s = time.perf_counter() - t0
        got = out[:r].cpu()
        cos = (got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1))
        if float(cos.min()) < self.QWEN3_COS:
            raise AssertionError(f"Qwen3 bf16 on the card against the CPU's "
                                 f"float32: cosine {cos.tolist()}")
        cut = dataclasses.replace(cfg32, num_layers=self.QWEN3_CUT)
        cut_cpu = forward(p.load_qwen3_state(cut, sd, device="cpu"), ids_h)
        cut_card = forward(p.load_qwen3_state(cut, sd, device=self.dev),
                           ids[:r]).cpu()
        cut_err = float((cut_card - cut_cpu).abs().max())
        if cut_err > self.CUT_ATOL:
            raise AssertionError(f"Qwen3 float32 cut: card against CPU "
                                 f"{cut_err} > {self.CUT_ATOL}")
        del sd, want, cut_cpu, cut_card

        # K1 on the vectors: its plan must take the model's depth.
        plan = p.topk_plan
        bq = plan.query_block(self.QWEN3_B, d, 32, "bfloat16")
        qres = plan.resident(bq, d, 32, "bfloat16")
        emb, _, _, bm25, terms = self.b.scale_2m_data(self.b.Scale2MConfig(
            n=self.N_MODELS, dim=d, batch=self.QWEN3_B, t=self.T,
            vocab=self.V, df=self.DF), self.dev)
        index = self.make_index(emb, bm25, self.N_MODELS)
        retr = p.FusedRetriever(index, (MODEL,), use_bm25=True,
                                similarity_k=32, common_sections_n=15,
                                budget=1024)
        assert retr.use_kernel, "the models' index must route to K1"
        w = {MODEL: 5.0, "BM25": 1.0}
        (fids, _, lists), counts = self.main_path(
            lambda: retr.retrieve_device({MODEL: out}, terms, w, None, 40.0))
        self.expect("models (a)", counts, fused_dense_top_k=1)
        plain = k.fused_dense_top_k_torch(emb, out, 32)
        swaps = p.check_top_k(plain[0], plain[1],
                              self.b.exact_dense(emb, out, lists[0]),
                              lists[0], BF16_ATOL)
        self.compare("fused_dense_top_k", plain,
                     k.fused_dense_top_k(emb, out, 32), BF16_ATOL)
        if not bool((fids[:, 0] >= 0).all()):
            raise AssertionError("a fused list came back empty")
        log(inference="A_qwen3", widths=self.QWEN3, params=n_params,
            non_embedding_params=non_emb, weight_gib=weight_gib,
            batch=list(ids.shape),
            valid_tokens=int(mask.sum()), init_s=init_s,
            forward_ms=forward_ms, profile=profile,
            bound_ms=flop / BF16_FLOP_S * 1e3,
            bound_flop=flop, attention_flop=attn_flop,
            cpu_rows=r, cos_min=float(cos.min()), unit_err=unit_err,
            cpu_reference_s=cpu_s, cut_layers=self.QWEN3_CUT,
            cut_max_abs_err=cut_err,
            k1_plan={"bq": bq, "resident": qres}, index=[self.N_MODELS, d],
            k1_launches=counts["fused_dense_top_k"],
            dense_list_swaps=swaps, card=self.card,
            method="forward_ms: CUDA events, median of 10 after 3 warm-ups; "
            "bound: 2 x non-embedding params x tokens at the bf16 peak; "
            "profile: the forward's kernels (torch.profiler; top_kernels by "
            "device ms a call), idle share and host enqueue ms")
        del index, retr, emb, bm25, out

    def phase21b_served_text(self, index, tokens) -> None:
        """The served text path on stage A's index: build_state with the
        hashing encoder (as serve_cli --embedder hashing builds it) and
        serve_state; text /v1/search replies equal to a direct
        retrieve_device on encode_text_query's vector and terms, one client
        (p50 / p99) and SERVED_CLIENTS clients (QPS), the text request's
        layers, and /v1/embeddings through http_api equal to
        embed_queries."""
        p, b = self.p, self.b
        import urllib.request
        emb = p.OnDeviceEmbedder(p.EncoderConfig(out_dim=self.D_A),
                                 device=self.dev)
        w = {MODEL: 5.0, "BM25": 1.0}
        state = p.build_state(
            index, (MODEL,), use_bm25=True, similarity_k=32,
            common_sections_n=15, budget=1024, embedder=emb,
            scheduler_kwargs={"max_batch": 2 * self.B, "max_wait_ms": 2.0,
                              "max_inflight": 4})
        retr, ids_of = state.retriever, index.meta.ids
        texts = [" ".join(t) for t in tokens]
        encoded = [state.encode_text_query(t) for t in texts]
        want = []
        for q_vec, terms in encoded:
            rows = retr.retrieve_device({MODEL: q_vec[None]}, terms[None], w,
                                        None, 40.0)[0][0].tolist()
            want.append([ids_of[j] for j in rows if j >= 0])
        n, counters = len(texts), self.pool_counters(state)

        def check(i, reply):
            got = [x["id"] for x in reply["results"]]
            if got != want[i] or not got:
                raise AssertionError(f"text query {i}: {got[:3]} against "
                                     f"a direct call's {want[i][:3]}")
            return np.asarray([got], dtype=object)

        def timed(one):
            lat = []
            for i in range(self.SERVED_LATENCY):
                t0 = time.perf_counter()
                one(i % n)
                lat.append((time.perf_counter() - t0) * 1e3)
            return {"p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "requests": len(lat)}

        def pooled(i):
            q_vec, terms = encoded[i]
            rows = state.submit_sync({MODEL: q_vec}, terms, w, None, 40.0)[0]
            if [ids_of[j] for j in rows.tolist() if j >= 0] != want[i]:
                raise AssertionError(f"pool text query {i}")

        one_ids = torch.as_tensor(emb.tokenizer.encode_batch(texts[:1]),
                                  device=self.dev)

        def embed_forward():
            with torch.inference_mode():
                return emb.model(one_ids)

        embed_profile = self.device_profile(embed_forward)
        embed_profile["top_kernels"] = p.profiled_top_kernels(embed_forward)
        layers = {
            "embed": timed(lambda i: emb.embed_queries([texts[i]])),
            "preprocess_text": timed(lambda i: index.pad_term_ids(
                [p.preprocess_text(texts[i], use_lemmatization=True)],
                state.t_max)),
        }
        server = p.serve_state(state, w, port=0, background=True)
        try:
            port = server.server_address[1]
            clients = itertools.count()

            def connect():
                seq = itertools.count(next(clients) * 7)
                sender = b.HttpSender(port, "")

                def send():
                    i = next(seq) % n
                    sender.body = json.dumps({"query": texts[i]})
                    return check(i, sender.post())
                return b.Sending(sender, send)

            def one_client():
                with connect() as send:
                    return timed(lambda i: send())

            b0, _ = counters()
            (layers["pool"], single, fronts), counts = self.main_path(
                lambda: (timed(pooled), one_client(), b.drive_front(
                    connect, self.SERVED_CLIENTS, self.SERVED_ROUNDS,
                    self.SERVED_PER, 1)))
            batches = counters()[0] - b0
        finally:
            server.shutdown()
        k1 = counts["fused_dense_top_k"]
        if k1 < batches or not batches:
            raise AssertionError(f"served text: K1 {k1} launches for "
                                 f"{batches} device batches")
        layers["http"] = single
        system = p.RAGSystem(indexes={p.InfoSource.NICE: index},
                             embedder=emb,
                             llm_clients={"fake": p.FakeLLMClient()},
                             device=self.dev)
        server = p.http_serve(system, port=0, background=True)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/v1/embeddings",
                data=json.dumps({"input": texts[:8]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                rows = json.loads(resp.read())["data"]
        finally:
            server.shutdown()
        vecs = np.asarray([x["embedding"] for x in rows], np.float32)
        if not np.array_equal(vecs, emb.embed_queries(texts[:8])):
            raise AssertionError("/v1/embeddings rows differ from "
                                 "embed_queries")
        below = sum(layers[x]["p50_ms"] for x in ("embed", "preprocess_text",
                                                  "pool"))
        log(inference="B_served_text", n=index.n_docs, texts=n,
            encoder={"dim": emb.cfg.dim, "layers": emb.cfg.n_layers,
                     "out_dim": emb.cfg.out_dim},
            text_p50_ms=single["p50_ms"], text_p99_ms=single["p99_ms"],
            served_qps_text={x: fronts[x] for x in ("qps_min", "qps_median",
                                                    "qps_max")},
            clients=fronts, layers=layers, embed_profile=embed_profile,
            http_over_layers_ms=(
                single["p50_ms"] - below),
            device_batches=batches, k1_launches=k1,
            ids_equal_direct=True, embeddings_equal=True, card=self.card,
            method="host clock around each request and its reply; layers: "
            "each alone over the same texts (embed_queries, preprocess_text "
            "with the index's term ids, the scheduler pool from this "
            "thread); embed_profile: the encoder's forward on one text; "
            "QPS: requests over each round's wall time")
        del state, system, emb

    def phase21c_pairs(self) -> None:
        """OnDeviceReranker (match features) and NliScorer (the cross-
        encoder with match features, EncoderConfig(n_layers=2)) over
        MODEL_PAIRS (query, document) pairs of the synthetic corpus: scores
        finite and within PAIR_ATOL of the CPU's float32 forward of the
        same weights, the rerank order equal wherever the CPU's gaps exceed
        it; ms a call."""
        p = self.p
        n_q = 16
        per = self.MODEL_PAIRS // n_q
        c = p.synth_corpus(n_docs=4 * self.MODEL_PAIRS, dim=16,
                           n_queries=n_q, seed=21)
        rng = np.random.default_rng(21)
        queries, groups = [], []
        row_of = {x: j for j, x in enumerate(c.ids)}
        for i in range(n_q):
            others = [x for x in c.ids if x != c.gold_ids[i]]
            docs = [c.gold_ids[i]] + [others[j] for j in rng.choice(
                len(others), per - 1, replace=False)]
            groups.append([{"id": x, "document": c.contents[row_of[x]]}
                           for x in docs])
            queries.append(" ".join(c.query_tokens[i]))
        qs = [q for q, g in zip(queries, groups) for _ in g]
        ds = [x["document"] for g in groups for x in g]
        rr = p.OnDeviceReranker(use_match_features=True, seed=21,
                                device=self.dev)
        cfg32 = dataclasses.replace(rr.cfg, dtype=torch.float32)
        rr_cpu = p.OnDeviceReranker(cfg32, state_dict=self.cpu_state(
            rr.model), use_match_features=True, device="cpu")
        nli = p.init_reranker(rr.cfg, seed=22, device=self.dev,
                              use_match_features=True)
        nli_cpu = p.init_reranker(cfg32, device="cpu",
                                  use_match_features=True)
        nli_cpu.load_state_dict(self.cpu_state(nli))
        tok = p.HashingTokenizer(vocab_size=rr.cfg.vocab_size)
        scorer, scorer_cpu = p.NliScorer(nli, tok), p.NliScorer(nli_cpu, tok)
        out = {}
        for name, card, cpu in (
                ("rerank", lambda: rr.score(qs, ds), lambda: rr_cpu.score(
                    qs, ds)),
                ("nli", lambda: scorer.score_batch(ds, qs),
                 lambda: scorer_cpu.score_batch(ds, qs))):
            got, ref = card(), cpu()
            if got.shape != (len(qs),) or not np.isfinite(got).all():
                raise AssertionError(f"{name} scores {got.shape}")
            err = float(np.abs(got - ref).max())
            if err > self.PAIR_ATOL:
                raise AssertionError(f"{name}: card against CPU {err}")
            out[name] = {"max_abs_err": err, "ms": self.host_call_ms(card),
                         "score_range": [float(ref.min()), float(ref.max())]}
        pairs_checked = 0
        for q, g in zip(queries, groups):
            got = rr.rerank(q, g)
            ref = {x["id"]: x["rerank_score"] for x in rr_cpu.rerank(q, g)}
            pos = {x["id"]: i for i, x in enumerate(got)}
            for a, bb in itertools.combinations(ref, 2):
                if ref[a] - ref[bb] > self.PAIR_ATOL:
                    pairs_checked += 1
                    if pos[a] > pos[bb]:
                        raise AssertionError(f"rerank order of {a}, {bb}")
        ids = torch.as_tensor(tok.encode_pairs(qs, ds), device=self.dev)

        def model_only():
            with torch.inference_mode():
                return rr.model(ids)
        out["rerank"]["device_ms"] = self.p.cuda_event_ms(model_only)
        log(inference="C_pairs", pairs=len(qs), queries=n_q, **out,
            order_pairs_checked=pairs_checked, atol=self.PAIR_ATOL,
            encoder={"dim": rr.cfg.dim, "layers": rr.cfg.n_layers},
            card=self.card,
            method="ms: host clock around one call over all pairs "
            "(tokenize, upload, forward, download), median of 3 after a "
            "warm-up; device_ms: CUDA events around the forward alone, "
            "median of 10 after 3 warm-ups")

    def models_summary(self) -> None:
        log(phase="models", parts=self.models_parts,
            seconds=sum(v["seconds"] for v in self.models_parts.values()),
            k1_launches=self.models_k1, card=self.card)

    # -- phase 22: generation ---------------------------------------------

    def gen_part(self, name, fn, *args):
        """Run one part of phase 22 as a path of its own: no kernel of the
        port is on it, so it must launch none."""
        return self.part(self.gen_parts, name, lambda: self.no_kernels(
            f"generation ({name})", lambda: fn(*args)))

    def gen_cfg(self):
        return self.b.GenConfig(**self.GEN)

    def phase22a_parity(self):
        """DecoderLM at the gen configuration's widths in bf16 on the card:
        the prefill logits of GEN_PROMPTS prompts against the CPU's float32
        forward of the same weights, cosine per (prompt, position) row.
        Returns the weights as a CPU float32 state dict."""
        p = self.p
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on: float32 products would not "
                                 "be float32")
        cfg = self.gen_cfg()
        model = self.b.gen_model(cfg, self.dev)
        ids = torch.randint(0, cfg.vocab, (self.GEN_PROMPTS,
                                           self.GEN_PROMPT_LEN),
                            generator=self.seed(2201), device=self.dev)
        got = p.lm_logits(model, ids).cpu()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("DecoderLM bf16 logits are not finite")
        sd = self.cpu_state(model)
        cfg32 = dataclasses.replace(model.cfg, dtype=torch.float32)
        del model
        t0 = time.perf_counter()
        want = p.lm_logits(p.load_decoder_state(cfg32, sd, device="cpu"),
                           ids.cpu())
        cpu_s = time.perf_counter() - t0
        # Phase 23 (a) holds the tensor-parallel logits against these.
        self.gen_ref = (ids, want)
        got, want = got.flatten(0, 1), want.flatten(0, 1)
        cos = (got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1))
        if float(cos.min()) < self.GEN_COS:
            raise AssertionError(f"DecoderLM bf16 logits against the CPU's "
                                 f"float32: cosine {float(cos.min())}")
        log(generation="A_parity", widths=dataclasses.asdict(cfg32) | {
            "dtype": "bfloat16"}, prompts=list(ids.shape),
            logits_rows=got.shape[0], cos_min=float(cos.min()),
            cos_median=float(cos.median()), cpu_reference_s=cpu_s,
            top1_agreement=float((got.argmax(-1) == want.argmax(-1))
                                 .float().mean()), card=self.card)
        return sd, cfg32

    def gen_streams(self, model, draft, prompts):
        """Every greedy stream of part (b) for one device's models."""
        p, eos = self.p, self.GEN_EOS
        out = {
            "stream_chunk1": list(p.generate_stream(
                model, prompts[0], max_new_tokens=24, eos_id=eos)),
            "stream_chunk8": list(p.generate_stream(
                model, prompts[0], max_new_tokens=24, eos_id=eos, chunk=8)),
            "batch": p.generate_batch(model, prompts[:3], max_new_tokens=16,
                                      eos_id=eos, chunk=8),
            "speculative": list(p.speculative_generate_stream(
                model, draft, prompts[0], max_new_tokens=24, gamma=4,
                eos_id=eos)),
        }

        def served(**kw):
            srv = p.GenerationServer(model, slots=4, max_len=128, chunk=4,
                                     eos_id=eos, **kw)
            reqs = [srv.submit(x, 12) for x in prompts]
            srv.drain()
            return srv, [self.gen_tokens(r) for r in reqs]

        out["server_wave"] = served()[1]
        out["server_per_slot"] = served(wave_prefill=False)[1]
        out["server_chunked"] = served(prefill_chunk=16)[1]
        srv, first = served(retain_prefixes=4)
        follow = prompts[0] + first[0] + [5, 6, 7]
        req = srv.submit(follow, 12)
        srv.drain()
        out["server_retained"] = [first[0], self.gen_tokens(req),
                                  srv.prefix_hits]
        con = p.compile_constraint(
            p.json_dfa(max_depth=self.GEN_JSON_DEPTH, top_level="object"),
            model.cfg.vocab_size, eos, name="json_object")
        srv = p.GenerationServer(model, slots=2, max_len=128, chunk=4,
                                 eos_id=eos,
                                 constraints={"json_object": con})
        out["json_object"] = self.gen_tokens(srv.submit(
            prompts[1], 48, constraint="json_object"), drain=srv)
        return out, srv

    @staticmethod
    def gen_tokens(req, drain=None):
        if drain is not None:
            drain.drain()
        toks = []
        while not req.out.empty():
            item = req.out.get_nowait()
            if isinstance(item, int):
                toks.append(item)
        return toks

    def phase22b_cut(self, sd, cfg32) -> None:
        """The float32 cut: greedy streams on the card equal to the CPU's,
        then sampled json_object requests on the card until one stops."""
        p = self.p
        cut = dataclasses.replace(cfg32, num_layers=self.GEN_CUT)
        one = dataclasses.replace(cfg32, num_layers=1)
        g = np.random.default_rng(2202)
        prompts = [g.integers(0, 256, n).tolist() for n in (20, 9, 33, 14)]
        runs = {}
        for dev in (self.dev, "cpu"):
            runs[str(dev)] = self.gen_streams(
                p.load_decoder_state(cut, sd, device=dev),
                p.load_decoder_state(one, sd, device=dev), prompts)
        (card, srv), (cpu, _) = runs[str(self.dev)], runs["cpu"]
        for name, want in cpu.items():
            if card[name] != want:
                raise AssertionError(f"generation cut, {name}: card "
                                     f"{card[name]} against CPU {want}")
        if card["speculative"] != card["stream_chunk1"]:
            raise AssertionError("the speculative stream is not the "
                                 "target's greedy stream")
        dfa = p.json_dfa(max_depth=self.GEN_JSON_DEPTH, top_level="object")
        state = 0
        for b in bytes(t for t in card["json_object"] if t < 256):
            state = int(dfa.next[state, b])
            if state < 0:
                raise AssertionError("the json_object stream left the "
                                     "grammar")
        parsed = tried = 0
        while not parsed and tried < self.GEN_JSON_TRIES:
            tried += 1
            out = srv.complete(prompts[tried % 4] + [tried], 64,
                               constraint="json_object", temperature=1.0)
            if out["finish_reason"] == "stop":
                json.loads(bytes(out["tokens"]).decode())
                parsed = tried
        srv.stop()
        if not parsed:
            raise AssertionError(f"no json_object request of {tried} "
                                 "stopped within its budget")
        log(generation="B_cut", layers=self.GEN_CUT, eos=self.GEN_EOS,
            streams={k: len(v) for k, v in card.items()},
            streams_equal_cpu=sorted(card),
            retained_prefix_hits=card["server_retained"][2],
            json_greedy_tokens=len(card["json_object"]),
            json_sampled_parsed_after=parsed, card=self.card)

    def phase22c_gen(self) -> None:
        """The bench's gen stage at the gen configuration's widths."""
        out = self.b.gen_stage(self.dev, 1, self.timer, self.gen_cfg(),
                               profile=self.b.gen_profile)
        log(generation="C_gen", **out, card=self.card,
            method="tok/s: host clock (stream: generate_stream at chunk 32 "
            "after a one-chunk warm-up; batched: 64 requests submitted, "
            "then drain); ttft: host clock from submit to the first token on "
            "the started server, each request alone; tick: one decode "
            "tick at full slots, host clock and a CUDA event pair, busy ms, "
            "launches and top kernels from one torch.profiler trace of 2 "
            "ticks; bound: weights "
            "+ the whole KV cache read once a step at 3.35 TB/s; wave peak: "
            "max_memory_allocated over the 64-wide admission tick")

    def phase22d_served(self, index, tokens) -> None:
        """serve_cli's local-LLM surface on stage A's index (demo weights,
        JSON mode): /v1/generate JSON and SSE, json_object chat, /v1/rag
        SSE from the local LLM."""
        p = self.p
        import urllib.request
        emb = p.OnDeviceEmbedder(p.EncoderConfig(out_dim=self.D_A),
                                 device=self.dev)
        state = p.build_state(index, (MODEL,), use_bm25=True,
                              similarity_k=32, common_sections_n=15,
                              budget=1024, embedder=emb)
        api = p.build_local_llm_api(index, state, emb, (MODEL,),
                                    gen_slots=4, gen_chunk=8,
                                    gen_max_len=1024, json_mode=True)
        prompt = "NICE guidance on " + " ".join(tokens[0][:6])
        want = "".join(p.generate_text_stream(api.gen_server.model, prompt,
                                              max_new_tokens=48))
        server = p.serve_state(state, {MODEL: 5.0, "BM25": 1.0}, port=0,
                               background=True, api=api)
        port = server.server_address[1]

        def post(path, payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=120)

        def sse(path, payload):
            t0, first, events = time.perf_counter(), None, []
            with post(path, payload) as resp:
                for raw in resp:
                    line = raw.decode().strip()
                    if line.startswith("data: "):
                        first = first or time.perf_counter() - t0
                        events.append(line[6:])
            if events[-1] != "[DONE]":
                raise AssertionError(f"{path} SSE ended {events[-1:]}")
            return events[:-1], first * 1e3, time.perf_counter() - t0

        try:
            with post("/v1/generate", {"prompt": prompt,
                                       "max_tokens": 48}) as resp:
                text = json.loads(resp.read())["text"]
            emitted = api.gen_server.stats()["tokens_emitted"]
            events, ttft_ms, seconds = sse("/v1/generate", {
                "prompt": prompt, "max_tokens": 48, "stream": True})
            tokens_out = api.gen_server.stats()["tokens_emitted"] - emitted
            streamed = "".join(json.loads(e)["delta"] for e in events)
            if text != want or streamed != want:
                raise AssertionError(f"/v1/generate {text!r} / {streamed!r} "
                                     f"against {want!r}")
            parsed = tried = 0
            while not parsed and tried < self.GEN_JSON_TRIES:
                tried += 1
                with post("/v1/chat/completions", {
                        "messages": [{"role": "user",
                                      "content": f"emit {tried}"}],
                        "max_tokens": 64, "temperature": 1.0,
                        "response_format": {"type": "json_object"}}) as r:
                    choice = json.loads(r.read())["choices"][0]
                if choice["finish_reason"] == "stop":
                    json.loads(choice["message"]["content"])
                    parsed = tried
            if not parsed:
                raise AssertionError(f"no json_object chat of {tried} "
                                     "stopped within its budget")
            emitted = api.gen_server.stats()["tokens_emitted"]
            rag, rag_ttft_ms, _ = sse("/v1/rag", {
                "query": " ".join(tokens[1]), "llm_model": "local-tpu",
                "use_hybrid_search": True, "use_reranker": False,
                "stream": True})
            sources = json.loads(rag[0])["sources"]
            answer = "".join(json.loads(e)["delta"] for e in rag[1:])
            stats = api.gen_server.stats()
            if not sources or not answer or answer.startswith("Error") \
                    or stats["tokens_emitted"] == emitted:
                raise AssertionError(f"/v1/rag: {len(sources)} sources, "
                                     f"answer {answer[:80]!r}")
        finally:
            server.shutdown()
        log(generation="D_served", n=index.n_docs,
            generate_equal_direct=True, sse_ttft_ms=ttft_ms,
            sse_tokens_per_s=tokens_out / seconds, sse_tokens=tokens_out,
            json_chat_parsed_after=parsed, rag_sources=len(sources),
            rag_answer_chars=len(answer), rag_sse_ttft_ms=rag_ttft_ms,
            server=stats, card=self.card,
            method="host clock from the request to the first SSE data "
            "line (ttft) and to [DONE] (tokens/s over the greedy text's "
            "byte tokens)")

    def gen_summary(self) -> None:
        log(phase="generation", parts=self.gen_parts,
            seconds=sum(v["seconds"] for v in self.gen_parts.values()),
            card=self.card)

    # -- phase 23: tensor-parallel generation and training --------------

    def train_part(self, name, fn, *args):
        """Run one part of phase 23 as a path of its own: parts (a), (b),
        (d) and (e) run no kernel of the port and must launch none; (c)
        serves through K1, its launches counted on the main path."""
        if name != "C":
            return self.part(self.train_parts, name, lambda: self.no_kernels(
                f"phase 23 ({name})", lambda: fn(*args)))
        k1 = self.main_launches["fused_dense_top_k"]
        out = self.part(self.train_parts, name, fn, *args)
        self.train_parts[name]["k1_launches"] = (
            self.main_launches["fused_dense_top_k"] - k1)
        return out

    def tp_mesh(self, tp):
        return self.p.make_mesh((tp,), ("tp",), devices=[self.dev] * tp)

    def tp_streams(self, model, draft, prompts, tp):
        """Part (a)'s greedy streams on one server setting: the staggered
        wave, speculative decoding and chunked prefill over a cached
        prefix; tp 1 is the one-slot server."""
        p, eos = self.p, self.GEN_EOS

        def server(**kw):
            return p.GenerationServer(model, max_len=128, chunk=4,
                                      eos_id=eos, mesh=None if tp == 1
                                      else self.tp_mesh(tp), **kw)

        def staggered(srv):
            first = srv.submit(prompts[0], 12)
            srv.tick()
            srv.tick()
            rest = [srv.submit(x, 12) for x in prompts[1:]]
            srv.drain()
            return [self.gen_tokens(r) for r in [first, *rest]]

        out = {"staggered_wave": staggered(server(slots=4)),
               "speculative": staggered(server(slots=4, draft_model=draft,
                                               gamma=4))}
        srv = server(slots=3, prefill_chunk=16)
        prefix = prompts[2][:24]
        srv.cache_prefix(prefix)
        reqs = [srv.submit(x, 9) for x in (prefix + prompts[0][:5],
                                           prompts[1], prompts[3])]
        srv.drain()
        out["chunked_prefix"] = [self.gen_tokens(r) for r in reqs]
        out["prefix_hits"] = srv.prefix_hits
        return out

    def tp_tok_s(self, model, tp):
        """tok/s of 64 requests x TP_NEW tokens over the gen
        configuration's slots and chunk, after a one-chunk warm-up."""
        cfg = self.gen_cfg()
        srv = self.p.GenerationServer(
            model, slots=cfg.slots, max_len=cfg.max_len, chunk=cfg.chunk,
            eos_id=-1, mesh=None if tp == 1 else self.tp_mesh(tp))
        prompt = list(range(2, 2 + cfg.prompt))
        warm = [srv.submit(prompt, cfg.chunk) for _ in range(cfg.slots)]
        srv.drain()
        for r in warm:
            self.gen_tokens(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [srv.submit(prompt, self.TP_NEW) for _ in range(cfg.slots)]
        srv.drain()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = sum(len(self.gen_tokens(r)) for r in reqs)
        if n != cfg.slots * self.TP_NEW:
            raise AssertionError(f"tp {tp}: {n} tokens of "
                                 f"{cfg.slots * self.TP_NEW}")
        return n / seconds

    def phase23a_tp_decode(self, sd, cfg32) -> None:
        """Phase 22's decoder split over tp slots of the card."""
        p = self.p
        model = self.b.gen_model(self.gen_cfg(), self.dev)
        ids, want = self.gen_ref
        want = want.flatten(0, 1)
        cos = {}
        for tp in self.TP_DEGREES:
            lm = p.shard_lm_params(model, self.tp_mesh(tp))
            kc, vc = lm.init_caches(*ids.shape)
            with torch.no_grad():
                got = lm(ids, kc, vc, 0)[0].flatten(0, 1).cpu()
            del lm, kc, vc
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"tp {tp}: logits are not finite")
            c = (got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1))
            cos[tp] = {"min": float(c.min()), "median": float(c.median()),
                       "top1_agreement": float((got.argmax(-1)
                                                == want.argmax(-1)).float()
                                               .mean())}
            if cos[tp]["min"] < self.GEN_COS:
                raise AssertionError(f"tp {tp}: bf16 logits against the "
                                     f"CPU's float32: cosine {cos[tp]}")
        tok_s = {tp: self.tp_tok_s(model, tp) for tp in (1, 2)}
        del model
        cut = dataclasses.replace(cfg32, num_layers=self.GEN_CUT)
        one = dataclasses.replace(cfg32, num_layers=1)
        target = p.load_decoder_state(cut, sd, device=self.dev)
        draft = p.load_decoder_state(one, sd, device=self.dev)
        g = np.random.default_rng(2301)
        prompts = [g.integers(0, 256, n).tolist() for n in (20, 9, 33, 14)]
        runs = {tp: self.tp_streams(target, draft, prompts, tp)
                for tp in (1, *self.TP_DEGREES)}
        for tp in self.TP_DEGREES:
            for name, streams in runs[1].items():
                if runs[tp][name] != streams:
                    raise AssertionError(f"tp {tp}, {name}: {runs[tp][name]}"
                                         f" against one slot's {streams}")
        if runs[1]["prefix_hits"] != 1:
            raise AssertionError("the cached prefix was not used")
        log(training="A_tp_decode", tp=list(self.TP_DEGREES),
            prompts=list(ids.shape), cos=cos, cut_layers=self.GEN_CUT,
            streams_equal_one_slot=sorted(k for k in runs[1]
                                          if k != "prefix_hits"),
            tok_s=tok_s,
            tok_s_tp2_over_tp1=tok_s[2] / tok_s[1],
            slots=self.gen_cfg().slots, chunk=self.gen_cfg().chunk,
            new_tokens=self.TP_NEW, card=self.card,
            method="tok/s: host clock from submitting a request a slot to "
            "the drained server, after a one-chunk warm-up; all tp slots "
            "on the one card, so tp > 1 adds launches and moves no bytes")

    def train_pairs(self, seed):
        """TRAIN_PAIRS (query, document) texts: a document holds 6 words
        of its own and 100 of a pool of TRAIN_WORDS shared by all; its
        query 3 of the 6 and 9 other pool words. The pool words swamp a
        seeded encoder's mean, so recall@1 starts near chance; it rises as
        training learns to weigh the words of one pair over the pool's."""
        g = np.random.default_rng(seed)
        pool = [stage_a_word(v) for v in range(self.TRAIN_WORDS)]
        queries, docs = [], []
        for i in range(self.TRAIN_PAIRS):
            own = [stage_a_word(self.TRAIN_WORDS + 6 * i + j)
                   for j in range(6)]
            doc = own + [pool[j] for j in g.choice(
                self.TRAIN_WORDS, 100, replace=False)]
            query = list(g.choice(own, 3, replace=False)) + [
                pool[j] for j in g.choice(self.TRAIN_WORDS, 9,
                                          replace=False)]
            docs.append(" ".join(g.permutation(doc)))
            queries.append(" ".join(g.permutation(query)))
        return queries, docs

    def first_step_vs_cpu(self, queries, docs):
        """One AdamW step from the same float32 weights on TRAIN_CPU_ROWS
        pairs, on the card and on the CPU."""
        p = self.p
        cfg = dataclasses.replace(p.EncoderConfig(**self.TRAIN),
                                  dtype=torch.float32)
        tok = p.HashingTokenizer(vocab_size=cfg.vocab_size)
        rows = self.TRAIN_CPU_ROWS
        q = torch.as_tensor(tok.encode_batch(queries[:rows]))
        d = torch.as_tensor(tok.encode_batch(docs[:rows]))
        out = {}
        for dev in (self.dev, "cpu"):
            enc = p.init_encoder(cfg, seed=23, device="cpu").to(dev)
            step, _ = p.make_train_step(enc)
            loss = float(step(q.to(dev), d.to(dev)))
            out[str(dev)] = (loss, self.cpu_state(enc))
        (loss, card), (want_loss, cpu) = out[str(self.dev)], out["cpu"]
        err = torch.cat([(card[k] - cpu[k]).abs().flatten() for k in cpu])
        past = float((err > self.PARAM_ATOL).float().mean())
        lr = 1e-3
        if abs(loss - want_loss) > self.TRAIN_LOSS_RTOL * abs(want_loss) \
                or past > self.PARAM_SHARE or float(err.max()) > 2.1 * lr:
            raise AssertionError(
                f"first step on the card against the CPU: loss {loss} / "
                f"{want_loss}, {past} of the parameters past "
                f"{self.PARAM_ATOL}, max {float(err.max())}")
        return {"rows": rows, "loss": loss, "cpu_loss": want_loss,
                "param_max_abs_err": float(err.max()),
                "param_share_past_atol": past}

    def phase23b_trainer(self, ckpt) -> None:
        """train_encoder at EncoderConfig's defaults, a checkpoint every
        TRAIN_EVERY steps, then one more epoch resumed from the last."""
        p = self.p
        cfg = p.EncoderConfig(**self.TRAIN)
        queries, docs = self.train_pairs(2302)
        first = self.first_step_vs_cpu(queries, docs)
        kw = dict(cfg=cfg, batch_size=self.TRAIN_BATCH, seed=23,
                  eval_every=self.TRAIN_EVERY, device=self.dev)
        before = p.train_encoder(queries, docs, epochs=0, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = p.train_encoder(queries, docs, epochs=self.TRAIN_EPOCHS,
                            checkpoint_dir=ckpt,
                            checkpoint_every=self.TRAIN_EVERY, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # Training's own peak: what was allocated before it (the resident
        # 2M index among it) is left out.
        peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
        steps = self.TRAIN_PAIRS // self.TRAIN_BATCH * self.TRAIN_EPOCHS
        saved = sorted(int(x) for x in os.listdir(ckpt))
        r0, r1 = before.eval_recall[-1][1], r.eval_recall[-1][1]
        if r.steps != steps or saved != list(range(
                self.TRAIN_EVERY, steps + 1, self.TRAIN_EVERY)):
            raise AssertionError(f"{r.steps} steps, checkpoints {saved}")
        if not r.losses[-1] < r.losses[0] or not r1 > r0:
            raise AssertionError(f"training: loss {r.losses[0]} -> "
                                 f"{r.losses[-1]}, recall@1 {r0} -> {r1}")
        resumed = p.train_encoder(queries, docs, epochs=1,
                                  checkpoint_dir=ckpt,
                                  checkpoint_every=10 ** 9, **kw)
        more = self.TRAIN_PAIRS // self.TRAIN_BATCH
        if resumed.steps != steps + more or \
                p.latest_step(ckpt) != steps + more:
            raise AssertionError(f"resume counted {resumed.steps} steps")
        tokens = 2 * steps * self.TRAIN_BATCH * p.HashingTokenizer().max_len
        log(training="B_trainer", widths={k: v for k, v in
                                          dataclasses.asdict(cfg).items()
                                          if k != "dtype"},
            dtype=str(cfg.dtype), pairs=self.TRAIN_PAIRS,
            batch=[self.TRAIN_BATCH, p.HashingTokenizer().max_len],
            steps=r.steps, loss_first=r.losses[0], loss_last=r.losses[-1],
            recall1_before=r0, recall1=r.eval_recall,
            resumed_steps=resumed.steps, resumed_loss=resumed.losses,
            checkpoints=saved + [resumed.steps], step_ms=seconds / steps * 1e3,
            tokens_per_s=tokens / seconds, peak_gib=peak,
            resident_gib=resident / 2**30,
            first_step_vs_cpu=first, card=self.card,
            method="host clock around train_encoder (its tokenizing, "
            "evals and checkpoints included) ending in a synchronize; "
            "tokens: queries and documents, padding included")

    def phase23c_served_ckpt(self, index, tokens, ckpt) -> None:
        """serve_cli --embedder hashing --embedder-ckpt over stage A's
        index: text replies equal to a direct embed + retrieve_device."""
        p = self.p
        import urllib.request
        emb = p.hashing_embedder(index, MODEL, ckpt)
        _, params, _ = p.restore_checkpoint(ckpt)
        for k, v in params.items():
            if not torch.equal(emb.model.state_dict()[k].cpu(), v):
                raise AssertionError(f"served encoder's {k} is not the "
                                     "checkpoint's")
        w = {MODEL: 5.0, "BM25": 1.0}
        state = p.build_state(index, (MODEL,), use_bm25=True,
                              similarity_k=32, common_sections_n=15,
                              budget=1024, embedder=emb)
        texts = [" ".join(t) for t in tokens[:self.RAG_QUERIES]]
        want = []
        for text in texts:
            q_vec = emb.embed_queries([text])
            terms = index.pad_term_ids(
                [p.preprocess_text(text, use_lemmatization=True)],
                state.t_max)
            rows = state.retriever.retrieve_device(
                {MODEL: q_vec}, terms, w, None, 40.0)[0][0].tolist()
            want.append([index.meta.ids[j] for j in rows if j >= 0])
        server = p.serve_state(state, w, port=0, background=True)

        def search():
            out = []
            for text in texts:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.server_address[1]}"
                    "/v1/search", data=json.dumps({"query": text}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    out.append([x["id"] for x in
                                json.loads(resp.read())["results"]])
            return out

        try:
            got, counts = self.main_path(search)
        finally:
            server.shutdown()
        if got != want or not all(got):
            raise AssertionError("served checkpoint: replies differ from a "
                                 "direct embed + retrieve_device")
        self.expect("served checkpoint", counts, at_least=True,
                    fused_dense_top_k=1)
        log(training="C_served_ckpt", n=index.n_docs, texts=len(texts),
            step=p.latest_step(ckpt), ids_equal_direct=True,
            k1_launches=counts["fused_dense_top_k"], card=self.card)
        del state, emb

    def phase23d_pair_trainers(self) -> None:
        """The reranker and the NLI scorer trained at their defaults."""
        p = self.p
        c = p.add_hard_distractors(
            p.calibrated_quality_corpus(**self.RERANK_CORPUS),
            **self.SWEEP_DISTRACTORS)
        index = p.build_index(ids=c.ids, sources=c.sources,
                              contents=c.contents, embeddings=c.embeddings,
                              token_lists=c.tokens, device=self.dev)
        n = self.RERANK_QUERIES
        gold, toks, q_emb, texts = p.calibrated_sample_queries(
            c, n, vocab_size=self.RERANK_CORPUS["vocab_size"], seed=99)
        got = p.SearchEngine(index, reranker=p.IdentityReranker()).retrieve(
            query_embeddings={MODEL: q_emb[MODEL]}, query_texts=texts,
            query_token_lists=toks, similarity_k=25, common_sections_n=15,
            wrrf_k=40.0, model_weights={MODEL: 5.0, "BM25": 1.0},
            use_hybrid_search=True)
        row_of = index.meta.id_to_row
        ranked = np.full((n, 15), -1, np.int64)
        for i, ids in enumerate(got):
            for j, d in enumerate(ids[:15]):
                ranked[i, j] = row_of.get(d, -1)
        qs, cands = p.mine_candidates(texts, list(gold), ranked, c.contents,
                                      n_negatives=5, seed=0)
        t0 = time.perf_counter()
        rr = p.train_cross_encoder_reranker(
            qs, cands, epochs=self.RERANK_EPOCHS, batch_size=32, seed=0,
            device=self.dev)
        rr_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nli = p.nli_scorer_for_corpus(NLI_DOCS, n_pairs=self.NLI_PAIRS,
                                      seed=0, epochs=self.NLI_EPOCHS,
                                      batch_size=32, device=self.dev)
        nli_s = time.perf_counter() - t0
        for name, r in (("reranker", rr), ("nli", nli)):
            if not r.losses[-1] < r.losses[0]:
                raise AssertionError(f"{name}: loss {r.losses[0]} -> "
                                     f"{r.losses[-1]}")
        if rr.holdout_accuracy < self.RERANK_FLOOR or \
                not nli.holdout_auc > self.NLI_AUC_FLOOR:
            raise AssertionError(f"holdout: reranker accuracy "
                                 f"{rr.holdout_accuracy}, NLI AUC "
                                 f"{nli.holdout_auc}")
        log(training="D_pair_trainers", docs=len(c.ids), queries=n,
            candidates=len(cands[0]),
            reranker={"steps": len(rr.losses), "loss_first": rr.losses[0],
                      "loss_last": rr.losses[-1], "seconds": rr_s,
                      "holdout_accuracy": rr.holdout_accuracy,
                      "holdout_floor": self.RERANK_FLOOR},
            nli={"pairs": self.NLI_PAIRS, "steps": len(nli.losses),
                 "loss_first": nli.losses[0], "loss_last": nli.losses[-1],
                 "seconds": nli_s, "holdout_auc": nli.holdout_auc,
                 "holdout_floor": self.NLI_AUC_FLOOR}, card=self.card)
        del index

    def parallel_batch(self, vocab, seed):
        g = np.random.default_rng(seed)
        t = g.integers(1, vocab, (self.PAR_BATCH,
                                  self.p.HashingTokenizer().max_len))
        t[1::2, 96:] = 0  # padded rows
        return torch.as_tensor(t, device=self.dev)

    def one_slot_step(self, model, q, d, aux=False):
        """One AdamW step of the plain model (the aux loss weighted as
        make_moe_train_step weighs it): its loss, gradients and weights."""
        p = self.p
        opt = p.adamw(model.parameters())
        opt.zero_grad(set_to_none=True)
        qe, de = model(q), model(d)
        if aux:
            loss = p.contrastive_loss(qe[0], de[0])
            total = loss + 0.01 * (qe[1] + de[1])
        else:
            loss = total = p.contrastive_loss(qe, de)
        total.backward()
        opt.step()
        named = dict(model.named_parameters())
        return (float(loss.detach()),
                {k: v.grad.detach().clone() for k, v in named.items()},
                {k: v.detach().clone() for k, v in named.items()})

    @staticmethod
    def gathered(name, params, attr):
        """A SlotParams' whole tensors (``attr`` "data" or "grad") from the
        first copy of each piece; every other copy must equal it."""
        out = {}
        for k, split in params.split.items():
            pieces = {}
            for idx in params.index:
                t = getattr(params.params[idx][k], attr).detach()
                j = 0 if split is None else idx[params.axes.index(split[0])]
                if j not in pieces:
                    pieces[j] = t
                elif not torch.equal(pieces[j], t.to(pieces[j].device)):
                    raise AssertionError(f"{name}: the copies of {k}'s "
                                         f"piece {j} differ ({attr})")
            first = pieces[0]
            out[k] = first if split is None else torch.cat(
                [pieces[j].to(first.device) for j in sorted(pieces)],
                split[1])
        return out

    def phase23e_parallel_steps(self) -> None:
        """The parallel train steps over 8 slots of the card, each against
        one step of the plain model from the same weights."""
        p = self.p
        cfg = p.EncoderConfig(**self.TRAIN)
        enc = p.init_encoder(cfg, seed=5, device=self.dev)
        sd = {k: v.clone() for k, v in enc.state_dict().items()}
        q, d = (self.parallel_batch(cfg.vocab_size, s) for s in (1, 2))
        one = self.one_slot_step(enc, q, d)  # sd keeps the weights before
        slots8, lr, out = [self.dev] * 8, 1e-3, {}

        def check(name, kind, step, params, want, as_flat=lambda x: x):
            first = float(step(q, d))
            want_loss, want_grads, want_weights = want
            raw = self.gathered(name, params, "data")
            grads = as_flat(self.gathered(name, params, "grad"))
            weights = as_flat(raw)
            if sorted(grads) != sorted(want_grads):
                raise AssertionError(f"{name}: parameters {sorted(grads)}")
            grad_err = max(float((grads[k] - g).norm() / g.norm().clamp(
                min=1e-30)) for k, g in want_grads.items())
            err = torch.cat([(weights[k] - w).abs().flatten()
                             for k, w in want_weights.items()])
            past = float((err > self.PARAM_ATOL).float().mean())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [first] + [float(step(q, d))
                                for _ in range(self.PAR_STEPS - 1)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / (self.PAR_STEPS - 1) * 1e3
            loss_err = abs(first - want_loss) / abs(want_loss)
            if loss_err > self.PAR_LOSS_RTOL[kind] or \
                    grad_err > self.PAR_GRAD_RTOL[kind] or \
                    past > self.PAR_PARAM_SHARE[kind] or \
                    float(err.max()) > 2.1 * lr or \
                    not losses[-1] < losses[0]:
                raise AssertionError(
                    f"{name}: losses {losses}, one slot {want_loss}; "
                    f"gradient relative error {grad_err}; {past} of the "
                    f"weights past {self.PARAM_ATOL}, max "
                    f"{float(err.max())}")
            for idx in params.index:
                for k, t in params.params[idx].items():
                    shape = list(raw[k].shape)
                    if params.split[k] is not None:
                        ax, dim = params.split[k]
                        shape[dim] //= params.grid.shape[
                            params.axes.index(ax)]
                    if list(t.shape) != shape:
                        raise AssertionError(f"{name}: slot {idx} holds {k} "
                                             f"{list(t.shape)}, not {shape}")
            out[name] = {"kind": kind, "losses": losses,
                         "one_slot_loss": want_loss,
                         "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                         "param_share_past_atol": past,
                         "param_max_abs_err": float(err.max()),
                         "step_ms": ms}

        for name, shape, axes, sp in (("dp4_tp2", (4, 2), ("dp", "tp"), None),
                                      ("dp2_tp2_sp2", (2, 2, 2),
                                       ("dp", "tp", "sp"), "sp")):
            mesh = p.make_mesh(shape, axes, devices=slots8)
            step, params, _, layout = p.make_sharded_train_step(
                enc, sd, mesh, sp_axis=sp)
            if layout != ("dp", sp):
                raise AssertionError(f"{name}: batch layout {layout}")
            check(name, "tp", step, params, one)
            del step, params
        for n_micro in (2, 3):
            mesh = p.make_mesh((2, 4), ("dp", "pp"), devices=slots8)
            step, pipe, _, _ = p.make_pipeline_train_step(
                cfg, sd, mesh, n_micro=n_micro)
            check(f"dp2_pp4_micro{n_micro}", "pp", step, pipe, one,
                  lambda flat: p.merge_pipeline_params(
                      *p.pipeline_parts(flat)))
            del step, pipe
        moe = p.init_moe_encoder(p.MoEEncoderConfig(), seed=6,
                                 device=self.dev)
        msd = {k: v.clone() for k, v in moe.state_dict().items()}
        mone = self.one_slot_step(moe, q, d, aux=True)
        mesh = p.make_mesh((2, 4), ("dp", "ep"), devices=slots8)
        step, params, _, _ = p.make_moe_train_step(moe, msd, mesh)
        check("dp2_ep4_moe", "ep", step, params, mone)
        log(training="E_parallel_steps", slots=8, widths={
            k: v for k, v in dataclasses.asdict(cfg).items()
            if k != "dtype"}, dtype=str(cfg.dtype),
            batch=list(q.shape), steps=self.PAR_STEPS,
            loss_rtol=self.PAR_LOSS_RTOL, grad_rtol=self.PAR_GRAD_RTOL,
            param_share=self.PAR_PARAM_SHARE, param_atol=self.PARAM_ATOL,
            meshes=out, card=self.card,
            method="first step against one step of the plain model from "
            "the same weights (every copy of a piece equal); step_ms: host "
            "clock over the steps after the first, ending in a "
            "synchronize; all 8 slots on the one card")

    def train_summary(self) -> None:
        log(phase="training", parts=self.train_parts,
            seconds=sum(v["seconds"] for v in self.train_parts.values()),
            k1_launches=self.train_parts["C"]["k1_launches"],
            card=self.card)

    # -- phase 24: the evaluation layer -----------------------------------

    def eval_part(self, name, fn, *args):
        """Run one part of phase 24 as a path of its own: the judge, the
        RAG answers (SearchEngine's plain routes) and the scorers run no
        kernel of the port, so it must launch none."""
        return self.part(self.eval_parts, name, lambda: self.no_kernels(
            f"evaluation ({name})", lambda: fn(*args)))

    @staticmethod
    def recorded(judge):
        """Wrap ``judge._one`` (one guided completion): the prompt's token
        count, the verdict, or the exception that ended it."""
        rec = {"prompt_tokens": [], "verdicts": [], "failures": []}
        one = judge._one

        def wrapped(prompt, temperature, constraint):
            rec["prompt_tokens"].append(len(judge.tokenizer.encode(prompt)))
            try:
                out = one(prompt, temperature, constraint)
            except Exception as e:
                rec["failures"].append(repr(e))
                raise
            rec["verdicts"].append(out)
            return out

        judge._one = wrapped
        return rec

    def judge_budget(self, rows, caps):
        """(max_tokens, prompt_tokens) of a judge over ``rows``:
        max_tokens is the longest sentence any of the two metrics' output
        schemas accepts under the string / list ``caps``, and the EOS
        after it, so every verdict stops; prompt_tokens the longest of
        their three prompts in byte tokens with the BOS, the NLI prompt's
        statements at their longest (a byte the decoder cannot read widens
        to U+FFFD, 3 bytes)."""
        p = self.p
        faith, rel = p.Faithfulness(), p.ResponseRelevancy()
        longest = {}
        for prompt in (faith.statement_prompt, faith.nli_prompt,
                       rel.question_prompt):
            longest[prompt.name] = longest_sentence(p.schema_dfa(
                prompt.output_model.model_json_schema(), compact=True,
                default_max_string=caps[0], default_max_items=caps[1]))
        statements = longest[faith.statement_prompt.name]
        prompt_bytes = 0
        for r in rows:
            prompt_bytes = max(
                prompt_bytes,
                len(faith.statement_prompt.render(p.StatementsIn(
                    question=r["user_input"], answer=r["response"]))
                    .encode()),
                len(faith.nli_prompt.render(p.NLIIn(
                    context="\n".join(r["retrieved_contexts"]),
                    statements=[])).encode()) + 3 * statements,
                len(rel.question_prompt.render(p.GenQuestionIn(
                    response=r["response"])).encode()))
        return max(longest.values()) + 1, prompt_bytes + 1

    def eval_samples(self):
        """EVAL_SAMPLES seeded rows over NLI_DOCS: a question, a response
        of two of a document's sentences, two documents as contexts."""
        g = np.random.default_rng(2400)
        rows = []
        for i in range(self.EVAL_SAMPLES):
            a, b = g.choice(len(NLI_DOCS), 2, replace=False)
            sents = self.p.sentences(NLI_DOCS[a])
            rows.append({
                "user_input": f"What does guideline {a} recommend ({i})?",
                "response": " ".join(sents[:2]),
                "retrieved_contexts": [NLI_DOCS[a], NLI_DOCS[b]],
            })
        return rows

    def judged(self, dev, sd, cfg, rows, caps):
        """evaluate(Faithfulness, ResponseRelevancy) over ``rows`` through
        the guided judge on a server over ``sd`` on ``dev``: the sorted
        verdicts, the registered constraint names, the scores."""
        p = self.p
        max_tokens, prompt = self.judge_budget(rows, caps)
        max_len = prompt + in_chunks(max_tokens, 4)
        model = p.load_decoder_state(cfg, sd, device=dev)
        srv = p.GenerationServer(model, slots=4, max_len=max_len, chunk=4)
        try:
            # default_temperature 0.0: the prompts' 1e-8 becomes argmax
            # (a positive temperature samples, and each device draws its
            # own noise).
            judge = p.LocalGuidedJudgeLLM(
                srv, max_tokens=max_tokens, max_string_len=caps[0],
                max_items=caps[1], default_temperature=0.0)
            rec = self.recorded(judge)
            result = p.evaluate(
                p.EvaluationDataset.from_list(rows),
                [p.Faithfulness(), p.ResponseRelevancy()], llm=judge,
                embeddings=p.FakeJudgeEmbeddings(),
                run_config=p.RunConfig(max_retries=0),
                raise_exceptions=True, show_progress=False)
            names = srv.stats()["constraints"]
        finally:
            srv.stop()
        scores = [{k: ("nan" if v != v else v) for k, v in s.items()}
                  for s in result.scores]
        return sorted(rec["verdicts"]), names, scores, max_tokens

    def phase24a_parity(self) -> None:
        """The guided judge on the card against the CPU: the small
        decoder (float32, seeded) under a greedy server on each, the same
        verdicts, constraint names and scores."""
        p = self.p
        cfg = p.small_lm_config()
        sd = self.cpu_state(p.init_decoder(cfg, seed=2401, device="cpu"))
        rows = self.eval_samples()
        card = self.judged(self.dev, sd, cfg, rows, self.EVAL_SMALL_CAPS)
        cpu = self.judged("cpu", sd, cfg, rows, self.EVAL_SMALL_CAPS)
        for what, got, want in zip(("verdicts", "constraints", "scores"),
                                   card, cpu):
            if got != want:
                raise AssertionError(f"judge parity, {what}: card {got} "
                                     f"against CPU {want}")
        verdicts, names, scores, max_tokens = card
        log(evaluation="A_parity", samples=len(rows), judge_calls=len(
            verdicts), constraints=names, scores=scores,
            max_tokens=max_tokens, caps=list(self.EVAL_SMALL_CAPS),
            verdicts_equal_cpu=True, card=self.card)

    def eval_index(self, index):
        """Stage A's index with a text for every document (made from its
        row on access: EVAL_CHUNK_BYTES of guideline-like sentences), the
        arrays shared."""
        docs = copy.copy(index)
        docs.meta = copy.copy(index.meta)
        docs.meta.contents = ChunkTexts(index.n_docs, self.EVAL_CHUNK_BYTES)
        return docs

    def phase24b_full_width(self, index) -> None:
        """The judged RAG evaluation at GEN's widths over stage A's index:
        questions from 8 of its chunks, RAG answers, the guided judge's
        Faithfulness and ResponseRelevancy, the CSVs. The weights are
        random, so the scores say nothing of quality: the part proves the
        path. The random vocabulary's ids past the bytes decode to no
        text, so the questions and answers are drawn under a constraint
        of plain sentences (the server's own decoding constraint, the
        judge's verdicts under their schemas')."""
        p = self.p
        docs = self.eval_index(index)
        embedder = p.hashing_embedder(docs, MODEL)
        model = self.b.gen_model(self.gen_cfg(), self.dev)
        g = np.random.default_rng(2402)
        rows_of = g.choice(docs.n_docs, self.EVAL_CHUNKS, replace=False)
        chunks = p.filter_chunks([
            {"title": f"CG_{r}", "source": docs.meta.sources[r],
             "content": docs.meta.contents[r]} for r in rows_of.tolist()])
        if len(chunks) != self.EVAL_CHUNKS:
            raise AssertionError(f"filter_chunks kept {len(chunks)} chunks")
        qc, ac = self.EVAL_QUESTION_CHARS, self.EVAL_ANSWER_CHARS
        question_re = rf"[A-Z][a-z ,']{{7,{qc - 2}}}\?"
        answer_re = rf"[A-Z][a-z0-9 ,;'()-]{{15,{ac - 2}}}\."
        # The budget from a worst row: the longest question and answer the
        # constraints allow, common_sections_n (15) documents as context.
        worst = [{"user_input": "Q" * qc, "response": "A" * ac,
                  "retrieved_contexts": [docs.meta.contents[0]] * 15}]
        max_tokens, prompt = self.judge_budget(worst, self.EVAL_CAPS)
        # The RAG prompt is cut to the judge's longest (its tail kept).
        step = self.EVAL_DECODE_CHUNK
        max_len = prompt + in_chunks(max(max_tokens, ac + 1), step)
        # Each prompt prefilled whole, one at a time: a wave of 8 NLI
        # prompts would hold [8, 16, L, L] float32 scores (~56 GB at L =
        # 10k), and a chunked prefill runs a decode chunk beside each of
        # its chunks, one prompt in flight.
        srv = p.GenerationServer(
            model, slots=self.EVAL_SLOTS, max_len=max_len,
            chunk=self.EVAL_DECODE_CHUNK, wave_prefill=False)
        srv.register_constraint("question", question_re)
        srv.register_constraint("answer", answer_re)
        srv.start()
        try:
            t0 = time.perf_counter()
            questions = p.generate_questions(
                chunks, p.LocalTpuLLMClient(
                    None, max_new_tokens=qc + 1, max_prompt_tokens=prompt - 1,
                    server=Constrained(srv, "question")),
                llm_model="local-qwen3", max_workers=self.EVAL_CHUNKS)
            q_s = time.perf_counter() - t0
            texts = [q["query"] for q in questions]
            if not all(re.fullmatch(question_re, t) for t in texts):
                raise AssertionError(f"questions {texts}")
            rag = p.RAGSystem(
                indexes={p.InfoSource.NICE: docs}, embedder=embedder,
                llm_clients={"local": p.LocalTpuLLMClient(
                    None, max_new_tokens=ac + 1,
                    max_prompt_tokens=prompt - 1,
                    server=Constrained(srv, "answer"))},
                device=self.dev)
            t0 = time.perf_counter()
            # One question a thread, so the answers decode as one wave.
            with ThreadPoolExecutor(len(texts)) as pool:
                rows = [r for part in pool.map(
                    lambda t: p.collect_rag_answers(
                        rag, [t], "local-qwen3",
                        model_weights={MODEL: 5.0, "BM25": 1.0},
                        use_reranker=False), texts) for r in part]
            rag_s = time.perf_counter() - t0
            for r in rows:
                if not re.fullmatch(answer_re, r["response"]) or len(
                        r["retrieved_contexts"]) != 15:
                    raise AssertionError(f"RAG row {r['response']!r}, "
                                         f"{len(r['retrieved_contexts'])} "
                                         "contexts")
            judge = p.LocalGuidedJudgeLLM(
                srv, max_tokens=max_tokens, max_string_len=self.EVAL_CAPS[0],
                max_items=self.EVAL_CAPS[1], default_temperature=0.0)
            rec = self.recorded(judge)
            repairs = []
            agenerate = judge.agenerate

            async def counted(prompt, n=1, temperature=1e-8, schema=None):
                if schema is None:
                    repairs.append(prompt[:60])
                return await agenerate(prompt, n, temperature, schema)

            judge.agenerate = counted
            tokens0 = srv.stats()["tokens_emitted"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = p.score_rows(
                rows, judge, p.EmbedderJudgeEmbeddings(embedder),
                show_progress=False)
            judge_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            tokens = srv.stats()["tokens_emitted"] - tokens0
            with tempfile.TemporaryDirectory() as tmp:
                agg = os.path.join(tmp, "ragas.csv")
                per = os.path.join(tmp, "ragas_rows.csv")
                p.write_results_csv(result, "local-qwen3", agg, per)
                with open(per, encoding="utf-8", newline="") as f:
                    table = list(csv.reader(f))
                if not os.path.exists(agg) or len(table) != len(rows) + 1:
                    raise AssertionError(f"CSV rows {len(table)}")
        finally:
            srv.stop()
        if rec["failures"] or repairs:
            raise AssertionError(f"judge failures {rec['failures']}, "
                                 f"repairs {repairs}, verdicts "
                                 f"{rec['verdicts'][:6]}")
        if len(rec["verdicts"]) < 2 * len(rows):
            raise AssertionError(f"{len(rec['verdicts'])} verdicts")
        self.check_scores(result, rec["verdicts"])
        pt = sorted(rec["prompt_tokens"])
        log(evaluation="B_full_width", widths=dataclasses.asdict(model.cfg)
            | {"dtype": str(model.cfg.dtype)}, index_docs=docs.n_docs,
            chunks=len(chunks), questions=len(texts), rag_rows=len(rows),
            judge_calls=len(rec["verdicts"]), repairs=len(repairs),
            all_stopped=True, max_tokens=max_tokens,
            caps=list(self.EVAL_CAPS), max_len=max_len,
            slots=self.EVAL_SLOTS, decode_chunk=self.EVAL_DECODE_CHUNK,
            prompt_tokens_p50=pt[len(pt) // 2], prompt_tokens_max=pt[-1],
            judge_seconds=judge_s, generated_tokens=tokens,
            tok_s=tokens / judge_s, peak_gib=peak,
            question_seconds=q_s, rag_seconds=rag_s,
            scores=result.aggregate(), csv_rows=len(table) - 1,
            card=self.card,
            method="judge_seconds: host clock around score_rows (all "
            "judge calls, the embedder's); tok/s: the server's emitted "
            "tokens over it; peak: max_memory_allocated over score_rows; "
            "random weights, so the scores carry no meaning")

    @staticmethod
    def check_scores(result, verdicts) -> None:
        """Every score a number in [0, 1], except where the metric itself
        defines NaN (its judge returned no statement, verdict or question)
        or a cosine, ResponseRelevancy's, below zero."""
        empty = any(re.search(r'"(statements|verdicts)":\[\]', v)
                    or '"question":""' in v for v in verdicts)
        for row in result.scores:
            for name, v in row.items():
                if v != v:
                    if not empty:
                        raise AssertionError(f"{name} NaN with every "
                                             "verdict filled")
                elif not (0.0 <= v <= 1.0 or (
                        name == "answer_relevancy" and -1.0 <= v < 0.0)):
                    raise AssertionError(f"{name} score {v}")

    def phase24c_discrimination(self) -> None:
        """FaithfulnesswithHHEM with an NLI scorer trained on the card
        must separate grounded from corrupted responses:
        tests/test_judge_discrimination.py's corpus, recipe, responders
        and floors, its questions through RAGSystem."""
        p = self.p
        c = p.calibrated_quality_corpus(**self.DISCRIM_CORPUS)
        contents = [sentenceify(t) for t in c.tokens]
        t0 = time.perf_counter()
        nli = p.nli_scorer_for_corpus(
            contents[:256], cfg=p.EncoderConfig(**self.DISCRIM_ENCODER),
            device=self.dev, **self.DISCRIM_NLI)
        train_s = time.perf_counter() - t0
        index = p.build_index(ids=c.ids, sources=c.sources,
                              contents=contents, embeddings=c.embeddings,
                              token_lists=c.tokens, device=self.dev)
        texts = c.texts()
        table = {t: c.query_embeddings[MODEL][i]
                 for i, t in enumerate(texts)}
        rng = np.random.default_rng(5)
        asked = {t: i for i, t in enumerate(texts)}

        def respond(corrupt):
            def answer(messages):
                user = messages[-1]["content"]
                ctx = [part.split("\nContext: ", 1)[1]
                       for part in user.split("\n\n---\n\n")
                       if "\nContext: " in part]
                sents = [s for d in ctx for s in p.sentences(d)]
                if not corrupt:
                    return " ".join(sents[:3])
                qi = asked[user.split("\n\nContext from", 1)[0]]
                far = p.sentences(contents[(100 + 7 * qi) % len(contents)])
                return " ".join(far[:2] + [p.negate(sents[0], rng)])
            return answer

        scores, t0 = {}, time.perf_counter()
        for kind in ("grounded", "corrupted"):
            rag = p.RAGSystem(
                indexes={p.InfoSource.NICE: index},
                embedder=p.PrecomputedEmbedder(table),
                llm_clients={"fake": p.FakeLLMClient(
                    respond(kind == "corrupted"))}, device=self.dev)
            rows = p.collect_rag_answers(
                rag, texts, "fake-llm", use_reranker=False,
                model_weights={MODEL: 5.0, "BM25": 1.0})
            scores[kind] = p.evaluate(
                p.EvaluationDataset.from_list(rows),
                [p.FaithfulnesswithHHEM(nli_scorer=nli.scorer)],
                llm=p.FakeJudgeLLM(statement_responder),
                raise_exceptions=True, show_progress=False,
            ).aggregate()["faithfulness_with_hhem"]
        judge_s = time.perf_counter() - t0
        low, high = self.DISCRIM_FLOORS
        if not (scores["grounded"] >= low and scores["corrupted"] <= high):
            raise AssertionError(f"faithfulness grounded "
                                 f"{scores['grounded']} (floor {low}), "
                                 f"corrupted {scores['corrupted']} "
                                 f"(ceiling {high})")
        log(evaluation="C_discrimination", docs=len(contents),
            questions=len(texts), nli_holdout_auc=nli.holdout_auc,
            nli_train_seconds=train_s, faithfulness=scores,
            floors={"grounded_min": low, "corrupted_max": high},
            rag_and_scoring_seconds=judge_s, card=self.card)

    def eval_summary(self) -> None:
        log(phase="evaluation", parts=self.eval_parts,
            seconds=sum(v["seconds"] for v in self.eval_parts.values()),
            card=self.card)

    def kernels_line(self) -> None:
        rows = []
        for name, (source, replaces) in KERNELS.items():
            ms, plain_ms = self.times[name]
            bound_ms, bound_by = self.bounds[name]
            rows.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": self.main_launches[name],
                "max_abs_err": self.max_err[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": self.library[name],
            })
        for row in rows:
            if row["launches"] < 1:
                raise AssertionError(f"{row['name']} never ran on the main path")
        print(json.dumps({"kernels": rows}), flush=True)

    def run(self) -> None:
        self.phase0_build()
        self.phase1_k1()
        self.phase2_k2()
        self.phase3_ivf_kernels()
        self.phase9_stream_kernels()
        self.phase13_14_probe_checks()
        self.phase15_keys()
        self.phase16_int4_exact()
        torch.cuda.empty_cache()
        self.phase10_stage_f()
        torch.cuda.empty_cache()
        emb, gold, q, bm25, terms = self.phase4_stage_a()
        terms_b = self.phase5_stage_b(emb, q, bm25, terms)
        self.phase17_search_engine(emb, gold, q, bm25, terms)
        self.phase18_reference_path(emb, gold, q, bm25, terms)
        sidx, got4, kw, w = self.sharded_part(
            "A", self.phase19a_sharded, emb, gold, q, bm25, terms)
        self.sharded_part("B", self.phase19b_sharded, emb, q, bm25, terms_b)
        ref_index, tokens = self.sharded_part(
            "E", self.phase19e_recovery, sidx, got4, kw, w, emb, q, bm25,
            terms)
        del sidx, got4
        self.sharded_part("F", self.phase19f_rag, ref_index, tokens, gold, q)
        del ref_index, tokens, terms_b
        torch.cuda.empty_cache()
        want, ref_index, tokens = self.served_part(
            "A", self.phase20a_served, emb, gold, q, bm25, terms)
        self.served_part("C", self.phase20c_served_sharded, ref_index, q,
                         terms, want)
        self.served_part("D", self.phase20d_served_rag, ref_index, tokens,
                         gold, q)
        del want
        torch.cuda.empty_cache()
        self.models_part("A", self.phase21a_qwen3)
        self.models_part("B", self.phase21b_served_text, ref_index, tokens)
        self.models_part("C", self.phase21c_pairs)
        self.models_summary()
        sd, cfg32 = self.gen_part("A", self.phase22a_parity)
        self.gen_part("B", self.phase22b_cut, sd, cfg32)
        self.gen_part("C", self.phase22c_gen)
        self.gen_part("D", self.phase22d_served, ref_index, tokens)
        self.gen_summary()
        self.train_part("A", self.phase23a_tp_decode, sd, cfg32)
        del sd
        with tempfile.TemporaryDirectory() as ckpt:
            self.train_part("B", self.phase23b_trainer, ckpt)
            self.train_part("C", self.phase23c_served_ckpt, ref_index,
                            tokens, ckpt)
        self.train_part("D", self.phase23d_pair_trainers)
        self.train_part("E", self.phase23e_parallel_steps)
        self.train_summary()
        torch.cuda.empty_cache()
        self.eval_part("A", self.phase24a_parity)
        self.eval_part("B", self.phase24b_full_width, ref_index)
        self.eval_part("C", self.phase24c_discrimination)
        self.eval_summary()
        del ref_index, tokens
        torch.cuda.empty_cache()
        self.time_k1(emb, q)
        self.phase11_floor("A", emb)
        self.phase12_overlap(emb)
        self.time_stream(emb)
        self.phase13_anatomy("A", emb, q, 32)
        self.phase14_counted("A", emb, q, 32)
        del emb, gold, q, bm25, terms
        torch.cuda.empty_cache()
        index, q, gold = self.phase6_stage_d()
        self.sharded_part("D", self.phase19d_sharded_ivf, index, q, gold)
        self.served_part("B", self.phase20b_served_ivf, index, q, gold)
        del index, q, gold
        torch.cuda.empty_cache()
        index, q, cent, gold = self.phase7_stage_c()
        self.sharded_part("C", self.phase19c_sharded, index, q, gold)
        del gold
        qd = index.dense_q[MODEL]
        self.phase11_floor("C", qd.values)
        torch.cuda.empty_cache()
        self.phase8_stage_e(index, cent)
        self.time_k2(qd.values, qd.scales, q)
        qv, qs = self.p.quantize_queries(q)
        self.phase13_anatomy("C", qd.values, qv, 25, qd.scales, qs)
        self.phase14_counted("C", qd.values, qv, 25, qd.scales, qs)
        self.phase16_int4_stage2(qd.values)
        self.phase19_summary()
        self.served_summary()
        log(phase="done", seconds=time.perf_counter() - self.t0)
        self.kernels_line()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)


class _Port:
    """The port's entry points, imported only after the checks above."""

    def __init__(self):
        from a_nice_rag_tpu_torch import bench, require_cuda
        from a_nice_rag_tpu_torch.config import InfoSource
        from a_nice_rag_tpu_torch.evals import (
            STANDARD_CONFIGURATIONS,
            RetrievalEvaluator,
        )
        from a_nice_rag_tpu_torch.evals.metrics import metrics_csv_row
        from a_nice_rag_tpu_torch.evals.replay_reference import (
            main as replay_main,
        )
        from a_nice_rag_tpu_torch.evals.retrieval_eval import seed42_split
        from a_nice_rag_tpu_torch.index import build_index
        from a_nice_rag_tpu_torch.index.manager import IndexManager
        from a_nice_rag_tpu_torch.ingest.bm25_tune import tune_bm25
        from a_nice_rag_tpu_torch.rag import FakeLLMClient, RAGSystem
        from a_nice_rag_tpu_torch.testing import (
            add_hard_distractors,
            calibrated_quality_corpus,
        )
        from a_nice_rag_tpu_torch.testing.reference_fixture import (
            write_reference_fixture,
        )
        from a_nice_rag_tpu_torch.text import preprocess_text
        from a_nice_rag_tpu_torch.utils.trace import device_profile
        from a_nice_rag_tpu_torch.index.array_index import (
            ArrayIndex,
            CorpusMeta,
        )
        from a_nice_rag_tpu_torch.index.ivf import (
            IVFDense,
            attach_ivf,
            build_tile_table,
            default_max_tiles,
        )
        from a_nice_rag_tpu_torch.ops import kernels
        from a_nice_rag_tpu_torch.ops.bm25 import Bm25Arrays
        from a_nice_rag_tpu_torch.ops.kernels._build import build_log
        from a_nice_rag_tpu_torch.ops.kernels.keys import row_plan
        from a_nice_rag_tpu_torch.ops.kernels.stream import sm_grid
        from a_nice_rag_tpu_torch.ops.kernels import anatomy, topk_plan
        from a_nice_rag_tpu_torch.ops.kernels import int4 as int4_kernels
        from a_nice_rag_tpu_torch.ops.kernels.fused_topk import (
            _sm_count,
            float_smem_bytes,
            int8_smem_bytes,
        )
        from a_nice_rag_tpu_torch.parallel import (
            DeviceHealthMonitor,
            ShardedRetriever,
            ShardedSearchEngine,
            default_probe,
            load_shard_ivf,
            make_mesh,
            save_shard_ivf,
            shard_index,
            shard_ivf,
            sharded_dense_top_k,
        )
        from a_nice_rag_tpu_torch.parallel.sharded import _gather_merge
        from a_nice_rag_tpu_torch.probes import (
            bf16_fold,
            dma_overlap,
            int4,
            iteration_count,
            kernel_anatomy,
        )
        from a_nice_rag_tpu_torch.ops.quantized import (
            QuantizedDense,
            quantize_embeddings,
            quantize_queries,
        )
        from a_nice_rag_tpu_torch.retrieval import (
            FusedRetriever,
            SearchEngine,
        )
        from a_nice_rag_tpu_torch.retrieval.engine import _ivf_coverage
        from a_nice_rag_tpu_torch.testing import (
            chained_ms,
            cuda_event_ms,
            device_loop_ms,
            profiled_device_ms,
            profiled_kernel_ms,
            profiled_top_kernels,
        )
        from a_nice_rag_tpu_torch.testing.parity import (
            check_stream_sum,
            check_stream_sum_busy,
            check_top_k,
        )

        from a_nice_rag_tpu_torch.models import (
            EncoderConfig,
            HashingTokenizer,
            NliScorer,
            OnDeviceEmbedder,
            OnDeviceReranker,
            Qwen3Config,
            init_qwen3,
            init_reranker,
            load_qwen3_state,
        )
        from a_nice_rag_tpu_torch.models.constrain import (
            compile_constraint,
            json_dfa,
        )
        from a_nice_rag_tpu_torch.models.convert import load_decoder_state
        from a_nice_rag_tpu_torch.models.decoder import (
            generate_batch,
            generate_stream,
            generate_text_stream,
            lm_logits,
        )
        from a_nice_rag_tpu_torch.models.speculative import (
            speculative_generate_stream,
        )
        from a_nice_rag_tpu_torch.serving.genserver import GenerationServer
        from a_nice_rag_tpu_torch.serving.serve_cli import (
            build_local_llm_api,
            hashing_embedder,
        )
        from a_nice_rag_tpu_torch.models import (
            MoEEncoderConfig,
            contrastive_loss,
            init_encoder,
            init_moe_encoder,
            make_moe_train_step,
            make_pipeline_train_step,
            make_sharded_train_step,
            make_train_step,
            merge_pipeline_params,
            mine_candidates,
            nli_scorer_for_corpus,
            train_cross_encoder_reranker,
        )
        from a_nice_rag_tpu_torch.models.pipeline import pipeline_parts
        from a_nice_rag_tpu_torch.models.train import adamw
        from a_nice_rag_tpu_torch.models.checkpoint import (
            latest_step,
            restore_checkpoint,
        )
        from a_nice_rag_tpu_torch.models.trainer import train_encoder
        from a_nice_rag_tpu_torch.parallel.lm import shard_lm_params
        from a_nice_rag_tpu_torch.retrieval.rerank import IdentityReranker
        from a_nice_rag_tpu_torch.testing import calibrated_sample_queries
        from a_nice_rag_tpu_torch.retrieval.embed import PrecomputedEmbedder
        from a_nice_rag_tpu_torch.testing import synth_corpus
        from a_nice_rag_tpu_torch.serving import (
            FeedbackLog,
            NativeFrontClient,
            NativeRetrievalFront,
        )
        from a_nice_rag_tpu_torch.serving.http_api import serve as http_serve
        from a_nice_rag_tpu_torch.serving.native_front import (
            bf16_bits,
            bf16_values,
        )
        from a_nice_rag_tpu_torch.serving.serve_cli import (
            build_state,
            serve_state,
        )
        from a_nice_rag_tpu_torch.evals.question_gen import (
            filter_chunks,
            generate_questions,
        )
        from a_nice_rag_tpu_torch.evals.ragas import (
            EvaluationDataset,
            FakeJudgeEmbeddings,
            FakeJudgeLLM,
            RunConfig,
            evaluate,
        )
        from a_nice_rag_tpu_torch.evals.ragas.embeddings import (
            EmbedderJudgeEmbeddings,
        )
        from a_nice_rag_tpu_torch.evals.ragas.llm import LocalGuidedJudgeLLM
        from a_nice_rag_tpu_torch.evals.ragas.metrics import (
            Faithfulness,
            FaithfulnesswithHHEM,
            ResponseRelevancy,
        )
        from a_nice_rag_tpu_torch.evals.ragas.metrics.answer_relevance import (
            GenQuestionIn,
        )
        from a_nice_rag_tpu_torch.evals.ragas.metrics.faithfulness import (
            NLIIn,
            StatementsIn,
        )
        from a_nice_rag_tpu_torch.evals.run_ragas_eval import (
            collect_rag_answers,
            score_rows,
            write_results_csv,
        )
        from a_nice_rag_tpu_torch.models.constrain import schema_dfa
        from a_nice_rag_tpu_torch.models.decoder import (
            init_decoder,
            small_lm_config,
        )
        from a_nice_rag_tpu_torch.models.nli import _negate, _sentences
        from a_nice_rag_tpu_torch.rag.providers import LocalTpuLLMClient

        self.filter_chunks, self.generate_questions = (filter_chunks,
                                                       generate_questions)
        self.EvaluationDataset, self.evaluate = EvaluationDataset, evaluate
        self.FakeJudgeEmbeddings, self.FakeJudgeLLM = (FakeJudgeEmbeddings,
                                                       FakeJudgeLLM)
        self.RunConfig = RunConfig
        self.EmbedderJudgeEmbeddings = EmbedderJudgeEmbeddings
        self.LocalGuidedJudgeLLM = LocalGuidedJudgeLLM
        self.Faithfulness, self.ResponseRelevancy = (Faithfulness,
                                                     ResponseRelevancy)
        self.FaithfulnesswithHHEM = FaithfulnesswithHHEM
        self.GenQuestionIn, self.NLIIn, self.StatementsIn = (
            GenQuestionIn, NLIIn, StatementsIn)
        self.collect_rag_answers, self.score_rows = (collect_rag_answers,
                                                     score_rows)
        self.write_results_csv, self.schema_dfa = (write_results_csv,
                                                   schema_dfa)
        self.init_decoder, self.small_lm_config = (init_decoder,
                                                   small_lm_config)
        self.negate, self.sentences = _negate, _sentences
        self.LocalTpuLLMClient = LocalTpuLLMClient

        self.hashing_embedder, self.shard_lm_params = (hashing_embedder,
                                                       shard_lm_params)
        self.MoEEncoderConfig, self.init_moe_encoder = (MoEEncoderConfig,
                                                        init_moe_encoder)
        self.make_moe_train_step = make_moe_train_step
        self.make_pipeline_train_step = make_pipeline_train_step
        self.merge_pipeline_params, self.pipeline_parts = (
            merge_pipeline_params, pipeline_parts)
        self.adamw = adamw
        self.make_sharded_train_step = make_sharded_train_step
        self.make_train_step, self.contrastive_loss = (make_train_step,
                                                       contrastive_loss)
        self.init_encoder, self.train_encoder = init_encoder, train_encoder
        self.mine_candidates = mine_candidates
        self.train_cross_encoder_reranker = train_cross_encoder_reranker
        self.nli_scorer_for_corpus = nli_scorer_for_corpus
        self.latest_step, self.restore_checkpoint = (latest_step,
                                                     restore_checkpoint)
        self.IdentityReranker = IdentityReranker
        self.calibrated_sample_queries = calibrated_sample_queries
        self.compile_constraint, self.json_dfa = compile_constraint, json_dfa
        self.load_decoder_state, self.lm_logits = (load_decoder_state,
                                                   lm_logits)
        self.generate_stream, self.generate_batch = (generate_stream,
                                                     generate_batch)
        self.generate_text_stream = generate_text_stream
        self.speculative_generate_stream = speculative_generate_stream
        self.GenerationServer = GenerationServer
        self.build_local_llm_api = build_local_llm_api
        self.build_state, self.serve_state = build_state, serve_state
        self.http_serve, self.FeedbackLog = http_serve, FeedbackLog
        self.NativeRetrievalFront = NativeRetrievalFront
        self.NativeFrontClient = NativeFrontClient
        self.bf16_bits, self.bf16_values = bf16_bits, bf16_values
        self.PrecomputedEmbedder = PrecomputedEmbedder
        self.Qwen3Config, self.init_qwen3 = Qwen3Config, init_qwen3
        self.load_qwen3_state, self.EncoderConfig = (load_qwen3_state,
                                                     EncoderConfig)
        self.OnDeviceEmbedder, self.OnDeviceReranker = (OnDeviceEmbedder,
                                                        OnDeviceReranker)
        self.init_reranker, self.NliScorer = init_reranker, NliScorer
        self.HashingTokenizer, self.synth_corpus = (HashingTokenizer,
                                                    synth_corpus)
        self.require_cuda = require_cuda
        self.bench, self.dma_overlap = bench, dma_overlap
        self.anatomy, self.kernel_anatomy = anatomy, kernel_anatomy
        self.iteration_count, self.bf16_fold = iteration_count, bf16_fold
        self.int4_probe = int4
        self.int4_kernels = int4_kernels
        self.fold_smem_bytes = int4_kernels.source_smem_bytes
        self.fold_active_clusters = int4_kernels.active_clusters
        self.topk_plan, self.int8_smem_bytes = topk_plan, int8_smem_bytes
        self.float_smem_bytes, self.sm_count = float_smem_bytes, _sm_count
        self.row_plan = row_plan
        self.sm_grid = sm_grid
        self.check_stream_sum = check_stream_sum
        self.check_stream_sum_busy = check_stream_sum_busy
        self.device_loop_ms, self.chained_ms = device_loop_ms, chained_ms
        self.profiled_kernel_ms = profiled_kernel_ms
        self.profiled_device_ms = profiled_device_ms
        self.profiled_top_kernels = profiled_top_kernels
        self.ArrayIndex, self.CorpusMeta = ArrayIndex, CorpusMeta
        self.IVFDense, self.attach_ivf = IVFDense, attach_ivf
        self.build_tile_table = build_tile_table
        self.default_max_tiles = default_max_tiles
        self.kernels = kernels
        self.Bm25Arrays = Bm25Arrays
        self.build_log = build_log
        self.QuantizedDense = QuantizedDense
        self.quantize_embeddings = quantize_embeddings
        self.quantize_queries = quantize_queries
        self.FusedRetriever = FusedRetriever
        self.SearchEngine = SearchEngine
        self.ivf_coverage = _ivf_coverage
        self.cuda_event_ms = cuda_event_ms
        self.check_top_k = check_top_k
        self.InfoSource, self.RAGSystem = InfoSource, RAGSystem
        self.FakeLLMClient, self.device_profile = FakeLLMClient, device_profile
        self.RetrievalEvaluator = RetrievalEvaluator
        self.STANDARD_CONFIGURATIONS = STANDARD_CONFIGURATIONS
        self.metrics_csv_row, self.seed42_split = metrics_csv_row, seed42_split
        self.replay_main, self.IndexManager = replay_main, IndexManager
        self.tune_bm25, self.build_index = tune_bm25, build_index
        self.add_hard_distractors = add_hard_distractors
        self.calibrated_quality_corpus = calibrated_quality_corpus
        self.write_reference_fixture = write_reference_fixture
        self.preprocess_text = preprocess_text
        self.make_mesh, self.shard_index = make_mesh, shard_index
        self.shard_ivf, self.ShardedRetriever = shard_ivf, ShardedRetriever
        self.save_shard_ivf, self.load_shard_ivf = (save_shard_ivf,
                                                    load_shard_ivf)
        self.sharded_dense_top_k, self.gather_merge = (sharded_dense_top_k,
                                                       _gather_merge)
        self.ShardedSearchEngine = ShardedSearchEngine
        self.DeviceHealthMonitor = DeviceHealthMonitor
        self.default_probe = default_probe


def main() -> int:
    if not (REPO / "a_nice_rag_tpu_torch" / "csrc" / "fused_topk.cu").is_file():
        print("chip_smoke.py must run from a checkout of the repository "
              "(a_nice_rag_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA GPU visible: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    Smoke(_Port()).run()
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
