"""Continuous-batching generation server for the on-device decoder LM (the
port of the JAX package's ``serving/genserver.py``).

The reference's generation hop is a per-request SaaS stream (reference
src/query_rag.py:434-513) — one connection per query, no batching.
Serving an LM on the card wants the opposite shape: decode is
memory-bound and a single stream leaves the card idle, so requests share
one batched decode. This module implements slot-based continuous
batching (the vLLM serving pattern):

* a fixed number of **slots** — rows of one batched KV cache
  [S, Smax, nkv, hd]. Admission and retirement never reshape anything;
* **admission** prefills a new request's prompt into a free slot's cache
  row (the prompt padded to a power-of-two bucket) while other slots keep
  decoding; a burst of admissions with one bucket prefills as one
  ``[W, bucket]`` forward whose row buffers are bucket-long;
* a **decode tick** advances every active slot by ``chunk`` tokens: the
  chunk's steps are enqueued with per-slot cache offsets
  (models/decoder._CachedBlock with ``cache_len`` [S]), per-slot EOS
  freezing and sampling on the device, and the tick downloads the
  ``[chunk, S]`` block once. Whether any row samples is decided from the
  host's copy of the per-slot knobs, never by reading the device;
* rows are independent under attention (masks and positions are per
  row), so each request's greedy stream is the one it would get alone
  through models/decoder.generate_stream.

Use ``tick()`` directly for deterministic stepping (tests, embedding into
an existing loop), or ``start()`` for a background thread feeding
per-request token queues (the HTTP /v1/generate SSE path).

``prefill_chunk=C`` turns admission into **incremental (chunked)
prefill**: a long prompt runs C tokens per tick into partial full-length
rows carried between ticks, interleaved with the decode ticks, so active
streams never stall longer than one chunk's forward. The chunked forward
is the same computation in pieces.

``constraints={name: spec}`` registers **guided decoding** grammars
(models/constrain.py: JSON mode, regexes, choice lists): the decode tick
gathers each slot's DFA row from one stacked device table, masks the
logits before sampling and carries the automaton state on the device —
``submit(constraint="name")`` makes invalid output unsamplable.

``draft_model=`` switches the decode tick to **batched speculative
decoding**: the draft proposes ``gamma`` tokens per slot, the target
verifies every slot's window in one forward, and each active slot
advances by its own accept count (1..gamma+1 tokens a tick). Greedy
streams stay the target-only server's.

``mesh=`` serves **tensor-parallel** over the mesh's ``tp`` slots
(parallel/lm.py): each slot holds its share of the heads and MLP columns
and only its kv heads of every layer's cache (the draft's too), and the
model's call dispatches every sublayer to the slots, so the admission,
decode and speculative paths below run unchanged. Greedy streams equal
the one-slot server's.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from a_nice_rag_tpu_torch.models.decoder import (
    EOS,
    PAD,
    ByteDecoder,
    ByteTokenizer,
    _decode_programs_constrained,
    _decode_programs_dynamic,
    gumbel,
    sample_logits_dynamic,
)

_END = object()  # sentinel on a request's token queue


class ServerBusy(RuntimeError):
    """Raised by submit() when the pending queue is at max_pending —
    backpressure for the HTTP surface (mapped to 429)."""


@dataclass
class _Request:
    prompt_ids: List[int]
    max_new_tokens: int
    out: "queue.Queue" = field(default_factory=queue.Queue)
    emitted: int = 0
    slot: int = -1
    cancelled: bool = False
    finished: bool = False
    # Per-request sampling knobs (resolved to the server defaults at
    # submit time; carried into the slot's row of the per-slot knobs).
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    # Tokens that terminate the stream like EOS (retired WITHOUT
    # emitting the stop token itself).
    stop_token_ids: Optional[frozenset] = None
    # Chosen-token logprobs under the model's raw distribution, one per
    # emitted token (empty in speculative mode — the verify step does not
    # surface per-token scores).
    logprobs: List[float] = field(default_factory=list)
    # "stop" (EOS / stop token), "length" (budget), or "cancelled".
    finish_reason: Optional[str] = None
    # Name of a server-registered decoding constraint; None =
    # unconstrained.
    constraint: Optional[str] = None
    # Per emitted token: the top-K raw-distribution alternatives as a
    # list of (token_id, logprob) pairs (only with logprob_topk=K).
    top_logprobs: List[list] = field(default_factory=list)
    # Emitted token values, server-side (prefix retention builds the
    # cached-prefix key from prompt + the forwarded emitted tokens).
    sent_ids: List[int] = field(default_factory=list)


class GenerationServer:
    """Slot-based continuous batching over the KV-cached decoder LM."""

    def __init__(
        self,
        model,
        slots: int = 4,
        max_len: int = 512,
        chunk: int = 8,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: int = EOS,
        seed: int = 0,
        min_prefill_bucket: int = 16,
        draft_model=None,
        gamma: int = 4,
        prefill_chunk: Optional[int] = None,
        max_pending: Optional[int] = None,
        mesh=None,
        constraints: Optional[dict] = None,
        logprob_topk: int = 0,
        retain_prefixes: int = 0,
        wave_prefill: bool = True,
        tp_axis: str = "tp",
    ):
        self.tp = 1
        if mesh is not None:
            from a_nice_rag_tpu_torch.parallel.lm import shard_lm_params

            model = shard_lm_params(model, mesh, tp_axis)
            if draft_model is not None:
                draft_model = shard_lm_params(draft_model, mesh, tp_axis)
            self.tp = model.tp
        self.model = model
        self.dev = model.device
        self.slots, self.smax, self.chunk = slots, max_len, chunk
        # top-K alternative logprobs per emitted token (the OpenAI
        # top_logprobs surface). 0 = off (no sort cost).
        self.lp_k = int(logprob_topk)
        # Batched wave prefill for burst admissions (see _admit); both
        # paths give the same streams.
        self.wave_prefill = bool(wave_prefill)
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.eos_id = eos_id
        self.min_bucket = min_prefill_bucket
        # Chunked (incremental) prefill: a long prompt is prefilled
        # ``prefill_chunk`` tokens per tick into PARTIAL rows carried
        # between ticks. One prefill in flight at a time; prompts that fit
        # in a single chunk still use the whole-prompt prefill. Partial
        # rows carry ``prefill_chunk`` positions of slack past max_len so
        # the final chunk's cache write never clamps (a clamped start
        # would shift the write backwards and corrupt the row); the slack
        # is trimmed at install time.
        if prefill_chunk is not None and not (
            1 <= prefill_chunk <= max_len
        ):
            raise ValueError(
                f"prefill_chunk must be in [1, max_len={max_len}], "
                f"got {prefill_chunk}"
            )
        self.prefill_chunk = prefill_chunk
        # Backpressure: submit() raises ServerBusy beyond this many
        # queued (not-yet-admitted) requests. None = unbounded.
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._pf: Optional[dict] = None
        self._next: Optional[_Request] = None  # FIFO head, re-queued
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._active: List[Optional[_Request]] = [None] * slots
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        cfg = model.cfg
        self._kc, self._vc = self._rows(model, slots, max_len)
        self._tok = torch.zeros(slots, dtype=torch.long, device=self.dev)
        self._pos = torch.zeros(slots, dtype=torch.long, device=self.dev)
        self._done = torch.ones(slots, dtype=torch.bool, device=self.dev)
        self._gen = torch.Generator(device=self.dev).manual_seed(seed)
        # Per-slot sampling knobs, kept on the host (uploaded only when a
        # row samples); rows default to the server-level knobs and
        # submit() overrides them per request.
        self._s_temp = np.full((slots,), temperature, np.float32)
        self._s_topk = np.full((slots,), top_k, np.int64)
        self._s_topp = np.full((slots,), top_p, np.float32)

        # Guided decoding: the registry is stacked into one [NC, Sm, V]
        # device tensor (id 0 = unconstrained identity); per-request
        # constraint choice is an [S] id vector. Servers built without
        # constraints keep the plain dynamic decode (no gather cost).
        self.constraints = constraints is not None
        self._cname_to_id: dict = {}
        if constraints is not None:
            self._init_constraint_registry()
            for name, spec in constraints.items():
                self._add_constraint(name, spec)
            self._rebuild_ctables()
        self._allow_all = torch.ones(cfg.vocab_size, dtype=torch.bool,
                                     device=self.dev)
        # prefix tuple -> (krows, vrows); insertion order is LRU order.
        self._prefix_cache: dict = {}
        self.prefix_cache_max = 8
        self.prefix_hits = 0
        # Automatic prefix retention: with retain_prefixes=N, a retired
        # request's KV row (already computed — zero extra forward work) is
        # kept as a cached prefix, so a follow-up request carrying the
        # conversation so far prefills only its new tail. The key covers
        # exactly the positions whose KV the row holds: the prompt plus
        # every FORWARDED emitted token — all of them when the row stopped
        # on EOS/stop, all but the last on budget/cancel (the final token
        # was sampled but never fed back). N bounds the LRU. Off in
        # speculative mode.
        self.retain_prefixes = int(retain_prefixes)
        if self.retain_prefixes > 0:
            self.prefix_cache_max = self.retain_prefixes
        self.prefix_retained = 0
        # Serving counters (stats()).
        self.ticks = 0
        self.tokens_emitted = 0
        self.cancelled_count = 0
        if self.constraints:
            self._chunk_steps = _decode_programs_constrained(
                model, eos_id, chunk, self.lp_k)
        else:
            self._chunk_steps = _decode_programs_dynamic(
                model, eos_id, chunk, self.lp_k)
        # Speculative mode: a draft model proposes gamma tokens per slot,
        # the target verifies every slot's window in one forward
        # (models/speculative.spec_round).
        self.draft, self.gamma = draft_model, gamma
        if draft_model is not None:
            self._dkc, self._dvc = self._rows(draft_model, slots, max_len)

    # ------------------------------------------------------------ API

    def submit(self, prompt_ids: List[int],
               max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop_token_ids=None,
               constraint: Optional[str] = None) -> _Request:
        """Enqueue a request; its tokens arrive on ``request.out``.

        ``temperature``/``top_k``/``top_p`` override the server-level
        sampling knobs FOR THIS REQUEST (None = server default).
        Speculative mode verifies against one static target distribution,
        so per-request overrides are rejected there.

        ``constraint`` names a server-registered decoding constraint:
        every sampled token is masked to what the constraint's DFA allows,
        so the output always matches the grammar (or ends with
        finish_reason "length" on budget exhaustion mid-sentence)."""
        if constraint is not None:
            if not self.constraints:
                raise ValueError(
                    "no constraints registered; construct the server "
                    "with GenerationServer(constraints={name: spec})"
                )
            if constraint not in self._cname_to_id:
                raise ValueError(
                    f"unknown constraint {constraint!r}; registered: "
                    f"{sorted(k for k in self._cname_to_id if k)}"
                )
            if self.draft is not None:
                raise ValueError(
                    "constrained decoding does not compose with "
                    "speculative mode (the verify step is unmasked)"
                )
        t = self.temperature if temperature is None else float(temperature)
        k = self.top_k if top_k is None else int(top_k)
        p = self.top_p if top_p is None else float(top_p)
        if self.draft is not None and (
            t != self.temperature or k != self.top_k or p != self.top_p
        ):
            raise ValueError(
                "per-request sampling overrides are not supported in "
                "speculative mode (the verify step bakes the target "
                "distribution); construct the server with the desired "
                "knobs instead"
            )
        if self.draft is not None:
            # An active row sits at pos = len(prompt) + emitted with
            # emitted <= budget - 1, and a spec round writes pos..pos+gamma
            # — so this bound keeps every write of an active row in range
            # (dead rows clamp-write inside their own row, which admission
            # prefill rewrites anyway).
            need = len(prompt_ids) + max_new_tokens + self.gamma
        else:
            n_chunks = -(-max_new_tokens // self.chunk)
            need = len(prompt_ids) + n_chunks * self.chunk
        if need > self.smax:
            raise ValueError(
                f"prompt({len(prompt_ids)}) + budget({max_new_tokens}) "
                f"needs {need} cache slots > max_len={self.smax}"
            )
        if self.max_pending is not None and (
            self._pending.qsize() + (self._next is not None)
            >= self.max_pending
        ):
            raise ServerBusy(
                f"pending queue full ({self.max_pending}); retry later"
            )
        req = _Request(list(prompt_ids), max_new_tokens,
                       temperature=t, top_k=k, top_p=p,
                       stop_token_ids=(
                           frozenset(int(i) for i in stop_token_ids)
                           if stop_token_ids else None
                       ),
                       constraint=constraint)
        self._pending.put(req)
        return req

    def cancel(self, req: _Request) -> None:
        """Abort a request. A pending request is never admitted; an active
        request's slot is retired immediately (its queue gets the end
        sentinel) and the next tick decodes without it; an in-flight
        incremental prefill is dropped. Called automatically when a
        ``stream()`` consumer closes the generator — e.g. the HTTP SSE
        handler on client disconnect."""
        with self._lock:
            if req.finished or req.cancelled:
                return
            req.cancelled = True
            req.finish_reason = "cancelled"
            self.cancelled_count += 1
            if req.slot >= 0 and self._active[req.slot] is req:
                if self._pf is not None and self._pf["req"] is req:
                    self._pf = None  # drop the in-flight prefill
                self._retire(req.slot)
            else:
                # Still pending (skipped at admission); unblock any
                # consumer waiting on the queue.
                req.out.put(_END)

    def stream(self, prompt_ids: List[int],
               max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop_token_ids=None,
               constraint: Optional[str] = None,
               info: Optional[dict] = None) -> Iterator[int]:
        """Submit and iterate tokens. Starts the background loop if it is
        not already running. Closing the generator early cancels the
        request and frees its slot. Pass a mutable ``info`` dict to
        receive ``info["finish_reason"]`` ("stop" | "length") when the
        stream ends normally."""
        if self._thread is None:
            self.start()
        req = self.submit(prompt_ids, max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, stop_token_ids=stop_token_ids,
                          constraint=constraint)
        try:
            while True:
                item = req.out.get()
                if item is _END:
                    if info is not None:
                        info["finish_reason"] = req.finish_reason
                    return
                yield item
        finally:
            self.cancel(req)  # no-op if the request finished normally

    def stream_text(self, prompt: str, max_new_tokens: int = 64,
                    tokenizer: Optional[ByteTokenizer] = None,
                    temperature: Optional[float] = None,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    stop: Optional[List[str]] = None,
                    stop_token_ids=None,
                    constraint: Optional[str] = None,
                    info: Optional[dict] = None) -> Iterator[str]:
        """Text streaming with optional STRING stop sequences: the stream
        ends just before the earliest match of any ``stop`` string (the
        match itself is never emitted) and the underlying request is
        cancelled. A holdback of ``max(len(s)) - 1`` characters handles
        stop strings that straddle token/chunk boundaries. A mutable
        ``info`` dict receives ``info["finish_reason"]``."""
        tok = tokenizer or ByteTokenizer()
        dec = (tok.stream_decoder() if hasattr(tok, "stream_decoder")
               else ByteDecoder())
        gen = self.stream(tok.encode(prompt), max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, stop_token_ids=stop_token_ids,
                          constraint=constraint, info=info)
        if not stop:
            for t in gen:
                piece = dec.feed(t)
                if piece:
                    yield piece
            tail = dec.flush()
            if tail:
                yield tail
            return

        hold = max(len(s) for s in stop) - 1
        buf = ""

        def _earliest(text: str) -> int:
            hits = [text.find(s) for s in stop]
            hits = [h for h in hits if h >= 0]
            return min(hits) if hits else -1

        try:
            for t in gen:
                piece = dec.feed(t)
                if not piece:
                    continue
                buf += piece
                cut = _earliest(buf)
                if cut >= 0:
                    if info is not None:
                        info["finish_reason"] = "stop"
                    if buf[:cut]:
                        yield buf[:cut]
                    return  # finally closes gen -> cancels the request
                if len(buf) > hold:
                    out, buf = buf[: len(buf) - hold], buf[len(buf) - hold:]
                    yield out
            buf += dec.flush()
            cut = _earliest(buf)
            if cut >= 0:
                buf = buf[:cut]
                if info is not None:
                    info["finish_reason"] = "stop"
            if buf:
                yield buf
        finally:
            gen.close()

    def complete(self, prompt_ids: List[int],
                 max_new_tokens: int = 64, **submit_kw) -> dict:
        """Blocking non-streaming completion. Returns ``tokens``, the
        per-token raw-distribution ``logprobs`` (empty in speculative
        mode), and ``finish_reason`` ("stop" | "length" | "cancelled")."""
        if self._thread is None:
            self.start()
        req = self.submit(prompt_ids, max_new_tokens, **submit_kw)
        toks = []
        while True:
            item = req.out.get()
            if item is _END:
                break
            toks.append(item)
        out = {"tokens": toks, "logprobs": list(req.logprobs),
               "finish_reason": req.finish_reason}
        if self.lp_k:
            out["top_logprobs"] = list(req.top_logprobs)
        return out

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._active)

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.smax)

    def _is_stop(self, req: _Request, token: int) -> bool:
        """EOS or a per-request stop token: retire without emitting."""
        return token == self.eos_id or (
            req.stop_token_ids is not None
            and token in req.stop_token_ids
        )

    def _set_slot_sampling(self, slot: int, req: _Request) -> None:
        self._s_temp[slot] = req.temperature
        self._s_topk[slot] = req.top_k
        self._s_topp[slot] = req.top_p
        if self.constraints:
            self._s_cid[slot] = self._cname_to_id.get(req.constraint, 0)

    # ------------------------------------------------- device helpers

    def _h2d(self, x, dtype) -> torch.Tensor:
        """A host array on the device, without waiting for queued work."""
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(
            self.dev, non_blocking=True)

    def _ids(self, rows: List[List[int]], width: int) -> torch.Tensor:
        ids = np.full((len(rows), width), PAD, np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
        return self._h2d(ids, torch.long)

    def _rows(self, model, batch: int, length: int):
        """Zeroed cache rows for ``model``: per layer, or per layer and
        tp slot for a tensor-parallel one."""
        return model.init_caches(batch, length)

    def _install(self, kc, vc, kr, vr, slots) -> None:
        """Copy row buffers [W, L, ...] into batch rows ``slots`` (an int
        or a [W] index tensor) of the shared caches, positions 0..L-1
        (trimmed to max_len). Positions past L keep what they held: a
        decode step writes a position before any query can attend it."""
        n = min(kr[0].shape[1], self.smax)
        for c, r in zip(kc + vc, kr + vr):
            if isinstance(slots, int):
                c[slots, :n] = r[0, :n]
            else:
                # A tensor-parallel slot's caches may sit on another card.
                c[slots.to(c.device), :n] = r[:, :n]

    def _knobs(self, reqs: List[_Request]):
        """Per-row knob tensors and noise for a prefill of ``reqs``, or
        Nones when every row is greedy (the knobs go unread)."""
        if not any(r.temperature > 0 for r in reqs):
            return None, None, None, None, False
        v = self.model.cfg.vocab_size
        noise = torch.stack([
            gumbel(self._gen, (v,), self.dev) if r.temperature > 0
            else torch.zeros(v, device=self.dev) for r in reqs])
        return (noise,
                self._h2d([r.temperature for r in reqs], torch.float32),
                self._h2d([r.top_k for r in reqs], torch.long),
                self._h2d([r.top_p for r in reqs], torch.float32), True)

    def _first_tokens(self, last, reqs: List[_Request], knobs):
        """Sample each row of ``last`` [W, V] with its request's knobs and
        first-token mask (the constraint's start-state row, all-true when
        unconstrained) applied BEFORE sampling. Returns the tokens [W] and
        the raw log-probabilities (+ top-K values and ids)."""
        noise, t, k, p, sampled = knobs
        allowed = torch.stack([self._req_allowed(r) for r in reqs])
        masked = torch.where(allowed, last, -math.inf)
        toks = sample_logits_dynamic(masked, noise, t, k, p, sampled)
        lsm = torch.log_softmax(last, dim=-1)
        lps = lsm.gather(-1, toks[:, None])[:, 0]
        if self.lp_k:
            tlv, tli = torch.topk(lsm, self.lp_k, dim=-1)
            return toks, lps, tlv, tli
        return toks, lps

    def _req_allowed(self, req: _Request) -> torch.Tensor:
        if not self.constraints or req.constraint is None:
            return self._allow_all
        return self._allowed0[self._cname_to_id[req.constraint]]

    def _set_slot_cstate(self, slot: int, req: _Request,
                         first: int) -> None:
        """Advance the DFA past the prefill's first token (host-side — the
        numpy table is at hand; decode ticks carry it on the device)."""
        if not self.constraints:
            return
        cid = self._cname_to_id.get(req.constraint, 0)
        ns = 0
        if cid:
            ns = max(int(self._cons[cid].table[0, first]), 0)
        self._cstate[slot] = ns

    @staticmethod
    def _download(parts) -> List[np.ndarray]:
        """One device->host copy of several tensors (token ids are exact
        in float32 below 2^24): float64 numpy arrays of their shapes."""
        flat = torch.cat([p.reshape(-1).float() for p in parts]).cpu()
        out, i = [], 0
        host = flat.numpy().astype(np.float64)
        for p in parts:
            out.append(host[i:i + p.numel()].reshape(tuple(p.shape)))
            i += p.numel()
        return out

    def _emit_first(self, slot: int, req: _Request, first: int,
                    lp: Optional[float], top) -> None:
        """Deliver a prefill's first token (or retire on a stop)."""
        self._set_slot_cstate(slot, req, first)
        if self._is_stop(req, first):
            self._retire(slot, "stop")
            return
        req.sent_ids.append(first)
        req.out.put(first)
        if lp is not None:
            req.logprobs.append(lp)
            if top is not None:
                req.top_logprobs.append(list(zip(
                    [int(i) for i in top[1]], top[0].tolist())))
        req.emitted = 1
        self.tokens_emitted += 1
        if req.emitted >= req.max_new_tokens:
            self._retire(slot, "length")

    # ------------------------------------------------ constraint registry

    def _init_constraint_registry(self) -> None:
        from a_nice_rag_tpu_torch.models.constrain import unconstrained

        self._cname_to_id = {None: 0, "none": 0}
        self._cons = [unconstrained(self.model.cfg.vocab_size)]

    def _add_constraint(self, name: str, spec) -> None:
        from a_nice_rag_tpu_torch.models.constrain import (
            Constraint,
            compile_constraint,
        )

        vocab = self.model.cfg.vocab_size
        con = (
            spec
            if isinstance(spec, Constraint)
            else compile_constraint(spec, vocab, self.eos_id, name=name)
        )
        if con.table.shape[1] != vocab:
            raise ValueError(
                f"constraint {name!r} vocab {con.table.shape[1]} != "
                f"model vocab {vocab}"
            )
        if name in self._cname_to_id:  # replace in place, id stable
            self._cons[self._cname_to_id[name]] = con
        else:
            self._cname_to_id[name] = len(self._cons)
            self._cons.append(con)

    def _rebuild_ctables(self) -> None:
        vocab = self.model.cfg.vocab_size
        sm = max(c.table.shape[0] for c in self._cons)
        stacked = np.full((len(self._cons), sm, vocab), -1, np.int32)
        for i, c in enumerate(self._cons):
            stacked[i, : c.table.shape[0]] = c.table
        self._ctables = torch.as_tensor(stacked, device=self.dev)
        self._allowed0 = torch.as_tensor(
            np.stack([c.allowed0() for c in self._cons]), device=self.dev)
        if not hasattr(self, "_cstate"):
            self._cstate = torch.zeros(self.slots, dtype=torch.long,
                                       device=self.dev)
            self._s_cid = np.zeros((self.slots,), np.int64)

    def register_constraint(self, name: str, spec) -> None:
        """Register (or replace) a decoding constraint AFTER construction
        — e.g. a per-prompt JSON-Schema DFA compiled on first use. The
        stacked table is rebuilt; existing constraint ids are stable, so
        in-flight constrained slots are unaffected. Works on servers built
        without ``constraints=`` too (the first registration switches the
        decode tick to the guided one)."""
        if not name or name == "none":
            raise ValueError("constraint name must be non-empty")
        with self._lock:
            if not self.constraints:
                self._init_constraint_registry()
                self._chunk_steps = _decode_programs_constrained(
                    self.model, self.eos_id, self.chunk, self.lp_k)
                self.constraints = True
            self._add_constraint(name, spec)
            self._rebuild_ctables()

    @torch.no_grad()
    def cache_prefix(self, prefix_ids: List[int]) -> None:
        """Precompute and store the KV rows for a shared prompt prefix
        (e.g. the RAG system prompt). Later requests whose prompt starts
        with it prefill only their suffix. LRU-bounded at
        ``prefix_cache_max`` entries (2 * layers * max_len * nkv * hd
        elements each)."""
        key_t = tuple(int(i) for i in prefix_ids)
        if not key_t:
            raise ValueError("empty prefix")
        if len(key_t) + self.chunk > self.smax:
            raise ValueError("prefix longer than the cache allows")
        ids = self._ids([list(key_t)], self._bucket(len(key_t)))
        kr, vr = self._rows(self.model, 1, self.smax)
        self.model(ids, kr, vr, 0)
        with self._lock:
            self._prefix_cache.pop(key_t, None)
            self._prefix_cache[key_t] = (kr, vr)
            while len(self._prefix_cache) > self.prefix_cache_max:
                self._prefix_cache.pop(next(iter(self._prefix_cache)))

    def _longest_cached_prefix(self, prompt: List[int]):
        """Best stored entry to continue ``prompt`` from, as ``(key, L)``
        where ``L`` is the usable common-prefix length (``L <=
        len(key)``), or ``None``. A stored row's KV at positions 0..L-1
        depends only on tokens 0..L-1 (causal attention), so a PARTIAL
        match is as good as a whole one: the suffix prefill at offset L
        overwrites the stale tail. At least one prompt token must remain
        to prefill (``L < len(prompt)``)."""
        best, best_l = None, 0
        cap = len(prompt) - 1
        for key_t in self._prefix_cache:
            n = min(len(key_t), cap)
            l = 0
            while l < n and key_t[l] == prompt[l]:
                l += 1
            # Ties go to the LATER (more recently used) entry.
            if l > 0 and l >= best_l:
                best, best_l = key_t, l
        return (best, best_l) if best is not None else None

    # ----------------------------------------------------------- loop

    def _next_request(self) -> Optional[_Request]:
        """Next pending request in FIFO order (the re-queued head, if any,
        comes first); requests cancelled while pending are discarded."""
        while True:
            if self._next is not None:
                req, self._next = self._next, None
            else:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    return None
            if not req.cancelled:
                return req

    def _has_pending(self) -> bool:
        return self._next is not None or not self._pending.empty()

    def _prefill_one(self, req: _Request, slot: int, bucket: int):
        """Whole-prompt prefill of ``req`` into cache row ``slot`` through
        bucket-long row buffers; returns the first-token outputs."""
        n = len(req.prompt_ids)
        kr, vr = self._rows(self.model, 1, bucket)
        logits, _, _ = self.model(self._ids([req.prompt_ids], bucket), kr,
                                  vr, 0)
        info = self._first_tokens(logits[:, n - 1], [req],
                                  self._knobs([req]))
        self._install(self._kc, self._vc, kr, vr, slot)
        return info

    def _prefill_wave(self, part, bucket: int):
        """Prefill W whole prompts of one length bucket in ONE [W, bucket]
        forward into bucket-long row buffers, sample each row with its
        own knobs and noise, and install the rows with one indexed copy a
        cache tensor."""
        reqs = [it[1] for it in part]
        w = len(part)
        kr, vr = self._rows(self.model, w, bucket)
        logits, _, _ = self.model(
            self._ids([r.prompt_ids for r in reqs], bucket), kr, vr, 0)
        lens = self._h2d([len(r.prompt_ids) for r in reqs], torch.long)
        last = logits[torch.arange(w, device=self.dev), lens - 1]
        info = self._first_tokens(last, reqs, self._knobs(reqs))
        self._install(self._kc, self._vc, kr, vr,
                      self._h2d([it[0] for it in part], torch.long))
        return info

    def _prefill_suffix(self, req: _Request, slot: int, key_t, offset):
        """Continue a cached prefix: run the prompt past ``offset`` over a
        copy of the stored rows (the stored ones stay as they are) and
        install the combined row into ``slot``."""
        suffix = req.prompt_ids[offset:]
        bucket = self._bucket(len(suffix))
        rows = self._prefix_cache.pop(key_t)
        self._prefix_cache[key_t] = rows  # refresh LRU position
        kr = [r.clone() for r in rows[0]]
        vr = [r.clone() for r in rows[1]]
        logits, _, _ = self.model(self._ids([suffix], bucket), kr, vr,
                                  offset)
        info = self._first_tokens(logits[:, len(suffix) - 1], [req],
                                  self._knobs([req]))
        self._install(self._kc, self._vc, kr, vr, slot)
        self.prefix_hits += 1
        return info

    def _prefill_draft(self, req: _Request, slot: int) -> None:
        """Prefill the draft's cache row for ``slot`` with the FULL prompt
        (no sampling — the first token comes from the target prefill)."""
        bucket = self._bucket(len(req.prompt_ids))
        kr, vr = self._rows(self.draft, 1, bucket)
        self.draft(self._ids([req.prompt_ids], bucket), kr, vr, 0)
        self._install(self._dkc, self._dvc, kr, vr, slot)

    def _admit(self) -> int:
        """Prefill pending requests into free slots; returns #admitted.

        Every free slot's prefill is enqueued first, then ONE download
        fetches all first tokens and log-probabilities. Whole-prompt,
        non-cached admissions are grouped by length bucket: each group of
        two or more runs as one batched forward (the largest power-of-two
        groups first; singletons take the per-slot prefill). Cache-hit,
        chunked and speculative admissions keep the per-slot paths."""
        admitted = 0
        staged = []  # (slot, req, info, row)
        wave = []  # (slot, req, bucket)
        for slot in range(self.slots):
            if self._active[slot] is not None:
                continue
            req = self._next_request()
            if req is None:
                break
            if (
                self.prefill_chunk is not None
                and len(req.prompt_ids) > self.prefill_chunk
            ):
                # Multi-chunk prompt -> incremental prefill, one in flight
                # at a time. Single-chunk prompts fall through to the
                # whole-prompt path below, so a short request is never
                # head-of-line blocked behind a long prefill.
                if self._pf is not None:
                    self._next = req  # keep FIFO; retry next tick
                    break
                self._start_chunked_prefill(req, slot)
                admitted += 1
                continue
            n = len(req.prompt_ids)
            self._set_slot_sampling(slot, req)
            hit = self._longest_cached_prefix(req.prompt_ids)
            if hit is not None and hit[1] + self._bucket(
                n - hit[1]
            ) <= self.smax:
                info = self._prefill_suffix(req, slot, *hit)
            else:
                bucket = self._bucket(n)  # n <= smax by submit()
                if self.draft is None and self.wave_prefill:
                    req.slot = slot
                    self._active[slot] = req
                    wave.append((slot, req, bucket))
                    admitted += 1
                    continue
                info = self._prefill_one(req, slot, bucket)
            if self.draft is not None:
                # The draft always prefills the full prompt (prefix
                # caching only covers the target's rows).
                self._prefill_draft(req, slot)
            req.slot = slot
            self._active[slot] = req
            staged.append((slot, req, info, 0))
            admitted += 1
        by_bucket: dict = {}
        for item in wave:
            by_bucket.setdefault(item[2], []).append(item)
        for bucket, items in by_bucket.items():
            i = 0
            while len(items) - i >= 2:
                w = 1
                while w * 2 <= len(items) - i:
                    w *= 2
                part = items[i:i + w]
                i += w
                info = self._prefill_wave(part, bucket)
                staged += [(s, rq, info, j)
                           for j, (s, rq, _b) in enumerate(part)]
            for slot, rq, b in items[i:]:
                staged.append((slot, rq, self._prefill_one(rq, slot, b), 0))
        if staged:
            self._finish_admission(staged)
        return admitted

    def _finish_admission(self, staged) -> None:
        """Set every admitted slot's token, position and finished flag
        with one indexed write each, then download every admission's
        first token and log-probability in one copy and deliver them."""
        firsts = torch.stack([info[0][j] for _, _, info, j in staged])
        slots_t = self._h2d([s for s, _, _, _ in staged], torch.long)
        self._tok[slots_t] = firsts
        self._pos[slots_t] = self._h2d(
            [len(r.prompt_ids) for _, r, _, _ in staged], torch.long)
        self._done[slots_t] = firsts == self.eos_id
        parts = [firsts]
        if self.draft is None:
            parts.append(torch.stack([info[1][j]
                                      for _, _, info, j in staged]))
            if self.lp_k:
                parts.append(torch.stack([info[2][j]
                                          for _, _, info, j in staged]))
                parts.append(torch.stack([info[3][j]
                                          for _, _, info, j in staged]))
        host = self._download(parts)
        for j, (slot, req, _info, _row) in enumerate(staged):
            lp = float(host[1][j]) if self.draft is None else None
            top = (host[2][j], host[3][j]) if self.lp_k and lp is not None \
                else None
            self._emit_first(slot, req, int(host[0][j]), lp, top)

    def _start_chunked_prefill(self, req: _Request, slot: int) -> None:
        """Reserve ``slot`` and set up the incremental prefill state;
        ``_advance_prefill`` runs one chunk per tick until done. The
        slot's ``done`` flag stays True so decode ticks freeze its row
        until the prefill installs real state."""
        c = self.prefill_chunk
        hit = self._longest_cached_prefix(req.prompt_ids)
        if hit is not None:
            key_t, done = hit
            rows = self._prefix_cache.pop(key_t)
            self._prefix_cache[key_t] = rows  # refresh LRU position
            # Slack past max_len so a final chunk starting near the end of
            # the row never clamps its write (see __init__); padding makes
            # new tensors, so the stored rows stay as they are.
            kr = [F.pad(r, (0, 0, 0, 0, 0, c)) for r in rows[0]]
            vr = [F.pad(r, (0, 0, 0, 0, 0, c)) for r in rows[1]]
            self.prefix_hits += 1
        else:
            kr, vr = self._rows(self.model, 1, self.smax + c)
            done = 0
        req.slot = slot
        self._active[slot] = req
        self._set_slot_sampling(slot, req)
        self._pf = dict(req=req, slot=slot, kr=kr, vr=vr, done=done,
                        n=len(req.prompt_ids))

    def _advance_prefill(self) -> None:
        """Run ONE prefill chunk of the in-flight incremental prefill; on
        the final chunk, sample the first token and install the rows —
        from then on the slot decodes like any other."""
        if self._pf is None:
            return
        pf = self._pf
        c = self.prefill_chunk
        off = pf["done"]
        real = min(c, pf["n"] - off)
        ids = self._ids([pf["req"].prompt_ids[off:off + real]], c)
        logits, _, _ = self.model(ids, pf["kr"], pf["vr"], off)
        pf["done"] = off + real
        if pf["done"] < pf["n"]:
            return
        slot, req = pf["slot"], pf["req"]
        info = self._first_tokens(logits[:, real - 1], [req],
                                  self._knobs([req]))
        self._install(self._kc, self._vc, pf["kr"], pf["vr"], slot)
        if self.draft is not None:
            self._prefill_draft(req, slot)
        self._pf = None
        self._finish_admission([(slot, req, info, 0)])

    def _retire(self, slot: int, reason: str = "stop") -> None:
        req = self._active[slot]
        if req is not None:
            req.finished = True
            if req.finish_reason is None:
                req.finish_reason = reason
            if (
                self.retain_prefixes > 0
                and self.draft is None
                and req.finish_reason in ("stop", "length")
            ):
                self._retain_row(slot, req)
            req.out.put(_END)
        self._active[slot] = None
        self._done[slot] = True

    def _retain_row(self, slot: int, req: _Request) -> None:
        """Keep the retired slot's KV row as a cached prefix (see
        retain_prefixes in __init__ for the forwarded-token key rule).
        The rows are copied, so the batch cache can be overwritten
        afterwards; zero forward work."""
        fwd = (req.sent_ids if req.finish_reason == "stop"
               else req.sent_ids[:-1])
        key = tuple(req.prompt_ids) + tuple(int(t) for t in fwd)
        if not key or len(key) + self.chunk > self.smax:
            return
        if key in self._prefix_cache:
            self._prefix_cache[key] = self._prefix_cache.pop(key)
            return
        kr = [c[slot:slot + 1].clone() for c in self._kc]
        vr = [c[slot:slot + 1].clone() for c in self._vc]
        self._prefix_cache[key] = (kr, vr)
        self.prefix_retained += 1
        while len(self._prefix_cache) > self.prefix_cache_max:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))

    def _sampling(self, decoding: List[int]):
        """(sampled, knobs) of a decode tick: whether any decoding slot
        samples, read from the host's knobs, and the [S] knob tensors
        (uploaded only then)."""
        if not any(self._s_temp[s] > 0 for s in decoding):
            return False, (None, None, None)
        return True, (self._h2d(self._s_temp, torch.float32),
                      self._h2d(self._s_topk, torch.long),
                      self._h2d(self._s_topp, torch.float32))

    def _decode(self, decoding: List[int]):
        """One decode tick on the device, then ONE download: per slot the
        emitted tokens, with their log-probabilities and top-K (None in
        speculative mode)."""
        if self.draft is not None:
            from a_nice_rag_tpu_torch.models.speculative import spec_round

            out, m, new_tok = spec_round(
                self.model, self.draft, self.gamma, self._tok, self._kc,
                self._vc, self._dkc, self._dvc, self._pos, self._gen,
                self.temperature, self.top_k, self.top_p)
            m = torch.where(self._done, 0, m)
            self._tok = torch.where(self._done, self._tok, new_tok)
            self._pos = self._pos + m
            block, counts = self._download([out, m])
            rows = [block[s, :int(counts[s])].astype(np.int64).tolist()
                    for s in range(self.slots)]
            return rows, None, None
        sampled, knobs = self._sampling(decoding)
        args = (self._tok, self._kc, self._vc, self._pos, self._gen,
                self._done, *knobs)
        if self.constraints:
            outs = self._chunk_steps(
                *args, self._h2d(self._s_cid, torch.long), self._cstate,
                self._ctables, sampled=sampled)
            self._cstate = outs[-1]
            outs = outs[:-1]
        else:
            outs = self._chunk_steps(*args, sampled=sampled)
        n_y = 4 if self.lp_k else 2
        (self._tok, self._kc, self._vc, self._pos, self._gen,
         self._done) = outs[n_y:]
        host = self._download(outs[:n_y])
        # One bulk conversion to Python values: the emit loop touches
        # every element.
        rows = host[0].T.astype(np.int64).tolist()
        lp_rows = host[1].T.tolist()
        tl = (host[2], host[3].astype(np.int64)) if self.lp_k else None
        return rows, lp_rows, tl

    @torch.no_grad()
    def tick(self) -> int:
        """Admit + one decode tick; returns #tokens emitted to request
        queues. Safe to call with no active work (no-op)."""
        with self._lock:
            self._admit()
            self._advance_prefill()
            pf_slot = self._pf["slot"] if self._pf is not None else -1
            decoding = [s for s, r in enumerate(self._active)
                        if r is not None and s != pf_slot]
            if not decoding and self._pf is not None:
                # No active streams to protect from jitter: run the
                # in-flight prefill to completion now instead of paying
                # one tick of TTFT per chunk for nothing.
                while self._pf is not None:
                    self._advance_prefill()
                pf_slot = -1
                decoding = [s for s, r in enumerate(self._active)
                            if r is not None]
            if not decoding:
                return 0
            rows, lp_rows, tl = self._decode(decoding)
            emitted = 0
            for slot in decoding:
                req = self._active[slot]
                for j, t in enumerate(rows[slot]):
                    if self._is_stop(req, t):
                        self._retire(slot, "stop")
                        break
                    req.sent_ids.append(t)
                    req.out.put(t)
                    if lp_rows is not None:
                        req.logprobs.append(lp_rows[slot][j])
                        if tl is not None:
                            req.top_logprobs.append(list(zip(
                                tl[1][j, slot].tolist(),
                                tl[0][j, slot].tolist(),
                            )))
                    req.emitted += 1
                    emitted += 1
                    if req.emitted >= req.max_new_tokens:
                        self._retire(slot, "length")
                        break
            self.ticks += 1
            self.tokens_emitted += emitted
            return emitted

    def stats(self) -> dict:
        """Serving counters for the /v1/stats surface: slot occupancy,
        queue depth, tick/token totals, prefix-cache hits, and
        cancellations."""
        with self._lock:
            return {
                "slots": self.slots,
                "active": self.n_active,
                "pending": self._pending.qsize()
                + (self._next is not None),
                "max_len": self.smax,
                "chunk": self.chunk,
                "ticks": self.ticks,
                "tokens_emitted": self.tokens_emitted,
                "prefix_cache_hits": self.prefix_hits,
                "prefixes_retained": self.prefix_retained,
                "cancelled": self.cancelled_count,
                "speculative": self.draft is not None,
                "constraints": sorted(
                    k for k in self._cname_to_id
                    if k and k != "none"
                ),
                "tensor_parallel": self.tp,
            }

    def drain(self, max_ticks: int = 10_000) -> None:
        """Tick until no pending and no active requests (tests/CLI)."""
        for _ in range(max_ticks):
            if self.n_active == 0 and not self._has_pending():
                return
            self.tick()
        raise RuntimeError("drain did not converge")

    # ------------------------------------------------- background mode

    def start(self, idle_sleep_s: float = 0.002) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                if self.n_active == 0 and not self._has_pending():
                    time.sleep(idle_sleep_s)
                    continue
                self.tick()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
