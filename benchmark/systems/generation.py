"""The generation system: the port's ``GenerationServer`` serving a
decoder LM to closed-loop clients, the answer step of RAG.

The configuration names its model's arch file (``"arch"``: found as
``archs/<name>.py`` beside this directory), the published widths
(``lm``), the compute dtype (``dtype``), ``GenerationServer``'s own
settings (``server``: ``slots``, ``max_len``, ``chunk``,
``prefill_chunk``, ``min_prefill_bucket``, ``retain_prefixes``,
``logprob_topk``), its ``limits`` and its ``rehearsal`` size.

The traffic (loop ``closed``): ``clients`` threads, each submitting its
next prompt as soon as the last reply has ended; every prompt starts with
the same ``shared_prefix_tokens`` ids (the system prompt and guideline
preamble), which the server holds as a cached prefix from set-up, as a
RAG deployment caches its system prompt; prompt lengths
(``prompt_tokens``, the shared prefix included) follow a lognormal law
clipped to [min, max]; each answer's budget (``new_tokens``) is one
number or such a law; ``pool_requests`` prompts, of which
``check_requests`` replies are judged. Every seed gets the same sizes in
each run of ``clients`` requests: the pool's lengths and budgets are
their laws' quantiles at (i + 1/2) / pool, each split into ``clients``
strata, and run r takes the r-th length and the r-th budget of each
stratum (the strata's members in one fixed order); the seed pairs them
and orders the run. Prompt ids are drawn from the seed over the
vocabulary, never the pad id.

Decoding is greedy with ``logprob_topk`` K: each emitted token carries
its log-probability and its top K. The server's EOS id is -1, which no
token takes (``_advance`` compares the sampled id with it, ``_is_stop``
the emitted one), so every answer runs its whole budget.

Set-up (``setup_s``, from the process's start to the window): the
weights made on the card from the seed, the model and the server built,
the shared prefix cached, and one request at each length the traffic's
prefill buckets turn on, each through one decode chunk. The window: the
clients send for ``seconds``; it closes when the last reply of a request
sent in it ends. ``qps``: answers over the window; ``p50_ms``,
``p95_ms``: submit to the last token. A traced run wraps the window in
the profiler every driver uses (``runner.start_profile``); its readers
get the ``device`` and ``server`` feeds (``FEEDS``). The server runs on
one card: a configuration with a ``mesh``, or a cell of more chips, is
refused.

Then the peak memory is read, the server stopped and the program freed,
the weights made again from the seed, and the sampled replies judged
against the arch's float32 reference, teacher-forced over each prompt
and its reply less the last token:

* ``missing``: requests of the window with no whole reply (an error, a
  cancel, or no end within the wait);
* ``length_err``: replies whose tokens, log-probabilities or top-K lists
  do not number the request's budget;
* ``logprob_gap``: the widest |program's log-probability of its token -
  the reference's|;
* ``topk_gap``: the same over every top-K alternative;
* ``greedy_gap``: the widest reference best log-probability - the
  reference's log-probability of the emitted token (zero unless rounding
  flips a near tie).

``control``: the reference one precision lower, put in the program's
place on the same replies: its first token at each position is its
choice, and the same three gaps are read of it.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import queue
import statistics
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from benchmark.harness.check import verdict
from benchmark.harness.gen import make_generator
from benchmark.harness.runner import (rehearsal_config, result_line,
                                      start_profile, traced_window)
from benchmark.harness.spec import Cell, check_name, load_module

# What a traced window gives the readers (``trace.Window``): the trace,
# and the server's counters over the window in ``stats``.
FEEDS = ("device", "server")
# One card, no mesh.
MESH_AXES = ()

REPLY_TIMEOUT_S = 120.0
# The server's EOS id: no sampled token equals it.
NO_TOKEN = -1
# The fixed order of each stratum's members over the pool's runs.
SIZE_ORDER = 13


@dataclasses.dataclass
class Answer:
    index: int                  # the prompt's place in the pool
    budget: int                 # the tokens asked for
    start: float                # host clock at submit
    first: Optional[float]      # at the first token
    end: float                  # at the end of the reply
    tokens: List[int]           # what the client received
    req: object                 # the server's request (logprobs, top K)
    error: Optional[str] = None  # why there is no whole reply


def arch_of(cell: Cell, cfg: dict):
    return load_module(cell.bench_dir / "archs"
                       / f"{check_name(cfg['arch'])}.py", "benchmark_arch_")


def quantiles(law, n: int, key: str) -> np.ndarray:
    """``n`` sizes of ``law``, ascending, the same for every seed: a
    lognormal law's quantiles at (i + 1/2) / n, rounded and clipped to
    [min, max]; a plain number ``n`` times."""
    if isinstance(law, (int, float)):
        return np.full(n, int(law), dtype=np.int64)
    if law["dist"] != "lognormal":
        raise ValueError(f"{key}: no law {law['dist']!r}")
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                  for i in range(n)])
    x = np.rint(law["median"] * np.exp(law["sigma"] * z))
    return np.clip(x, law["min"], law["max"]).astype(np.int64)


def pool_order(traffic: dict, seed: int) -> np.ndarray:
    """The pool's (length, budget) pairs in request order: run r of
    ``clients`` requests holds the r-th member of each stratum of lengths
    and of budgets, the same for every seed; the seed pairs them and
    orders the run."""
    n, c = traffic["pool_requests"], traffic["clients"]
    if n % c:
        raise ValueError("pool_requests must be a multiple of clients")
    fixed = np.random.default_rng(np.random.SeedSequence([SIZE_ORDER]))
    grids = []
    for key in ("prompt_tokens", "new_tokens"):
        grid = quantiles(traffic[key], n, key).reshape(c, -1)  # stratum: row
        grids.append(np.take_along_axis(
            grid, np.argsort(fixed.random(grid.shape), axis=1), axis=1))
    lengths, budgets = grids
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
    return np.asarray([(lengths[s, r], budgets[b, r])
                       for r in range(n // c)
                       for s, b in zip(rng.permutation(c),
                                       rng.permutation(c))])


def token_ids(g: torch.Generator, n: int, vocab: int,
              pad_id: int) -> List[int]:
    """``n`` ids drawn from ``g`` over the vocabulary less the pad id."""
    ids = torch.randint(0, vocab - 1, (n,), generator=g)
    return (ids + (ids >= pad_id).long()).tolist()


def prompts(traffic: dict, vocab: int, pad_id: int, seed: int):
    """(shared prefix ids, the pool's prompts, their budgets): token lists
    from the seed, each prompt the shared prefix and then its own ids."""
    order = pool_order(traffic, seed)
    lengths, budgets = order[:, 0], order[:, 1].tolist()
    shared = int(traffic["shared_prefix_tokens"])
    if lengths.min() <= shared:
        raise ValueError("every prompt must outrun the shared prefix")
    ids = token_ids(make_generator("cpu", seed, "prompt-ids"),
                    shared + int((lengths - shared).sum()), vocab, pad_id)
    prefix, at, out = ids[:shared], shared, []
    for n in lengths.tolist():
        out.append(prefix + ids[at:at + n - shared])
        at += n - shared
    return prefix, out, budgets


def warm_lengths(traffic: dict) -> List[int]:
    """Prompt lengths that turn on every prefill bucket the traffic can
    make, whole or after the cached prefix: the ends of the law and each
    power of two between them, alone and past the prefix."""
    law = traffic["prompt_tokens"]
    lo, hi = int(law["min"]), int(law["max"])
    shared = int(traffic["shared_prefix_tokens"])
    out = {lo, hi}
    b = 1
    while b < hi:
        b *= 2
        out.update(n for n in (b, b + 1, b + shared, b + shared + 1)
                   if lo <= n <= hi)
    return sorted(out)


class Clients:
    """Closed-loop clients of one server."""

    def __init__(self, server, pool: Sequence[List[int]],
                 budgets: Sequence[int]):
        self.server, self.pool, self.budgets = server, pool, budgets
        # The pool's next prompt.
        self.next = itertools.count()

    def ask(self, i: int, prompt: Optional[List[int]] = None,
            new_tokens: Optional[int] = None) -> Answer:
        """Submit one prompt and wait for the end of its reply, as
        ``GenerationServer.complete`` does, noting the first token."""
        if prompt is None:
            prompt, new_tokens = self.pool[i], self.budgets[i]
        t0 = time.perf_counter()
        first, toks, req, error = None, [], None, None
        try:
            req = self.server.submit(prompt, new_tokens)
            while True:
                item = req.out.get(timeout=REPLY_TIMEOUT_S)
                if not isinstance(item, int):  # the end of the reply
                    break
                if first is None:
                    first = time.perf_counter()
                toks.append(item)
            if req.finish_reason == "cancelled":
                error = "cancelled"
        except queue.Empty:
            error = "no end within the wait"
            self.server.cancel(req)
        except Exception as e:  # noqa: BLE001 — a failed request
            error = repr(e)
        return Answer(i, new_tokens, t0, first, time.perf_counter(), toks,
                      req, error)

    def drive(self, clients: int, seconds: float) -> List[Answer]:
        """``clients`` threads, each sending the pool's next prompt as soon
        as its last reply has ended, while the window (``seconds``) is
        open; each waits for the end of every reply it asked for."""
        stop_at = time.perf_counter() + seconds
        done: List[Answer] = []

        def client():
            while time.perf_counter() < stop_at:
                done.append(self.ask(next(self.next) % len(self.pool)))

        threads = [threading.Thread(target=client, name=f"client-{c}")
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return done


def sample_answers(answers: List[Answer], pool, n: int,
                   seed: int) -> List[Answer]:
    """The replies to judge: the longest prompt's, and the rest drawn
    from the seed among the whole replies."""
    ok = [a for a in answers if a.error is None and a.tokens]
    if not ok:
        return []
    longest = max(range(len(ok)), key=lambda j: len(pool[ok[j].index]))
    rest = [j for j in range(len(ok)) if j != longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    pick = [rest[int(p)] for p in rng.permutation(len(rest))[:n - 1]]
    return [ok[j] for j in sorted([longest] + pick)]


def _gaps(ref: torch.Tensor, chosen: torch.Tensor, chosen_lp: torch.Tensor,
          alt: torch.Tensor, alt_lp: torch.Tensor) -> dict:
    """The three gaps of one reply against the reference's rows ``ref``
    [T, V]: its tokens ``chosen`` [T] with their log-probabilities, and
    its top-K ``alt`` [T, K] with theirs."""
    at = ref.gather(1, chosen[:, None])[:, 0]
    return {"logprob_gap": float((chosen_lp - at).abs().max()),
            "topk_gap": float((alt_lp - ref.gather(1, alt)).abs().max()),
            "greedy_gap": float((ref.max(1).values - at).max())}


def judge(arch, lm: dict, state: dict, pool, picks: List[Answer], k: int,
          device, control: bool = False):
    """(program's gaps, control's gaps or None) over the picked replies:
    the widest over every judged position."""
    prog, ctl = {}, {} if control else None

    def widest(into, got):
        for name, v in got.items():
            into[name] = max(into.get(name, 0.0), v)

    for a in picks:
        toks = a.tokens[:a.budget]
        if len(a.req.logprobs) < len(toks) or \
                len(a.req.top_logprobs) < len(toks):
            continue  # counted under length_err
        ids = torch.tensor(pool[a.index] + toks[:-1], device=device)
        ref = arch.reference_logprobs(lm, state, ids, last=len(toks))
        chosen = torch.tensor(toks, device=device)
        lp = torch.tensor(a.req.logprobs[:len(toks)], device=device)
        alt = torch.tensor([[t for t, _ in top[:k]] for top in
                            a.req.top_logprobs[:len(toks)]], device=device)
        alt_lp = torch.tensor([[v for _, v in top[:k]] for top in
                               a.req.top_logprobs[:len(toks)]],
                              device=device, dtype=torch.float32)
        widest(prog, _gaps(ref, chosen, lp, alt, alt_lp))
        if control:
            low = arch.reference_logprobs(lm, state, ids, control=True,
                                          last=len(toks))
            c_alt_lp, c_alt = low.topk(k, dim=1)
            widest(ctl, _gaps(ref, c_alt[:, 0], c_alt_lp[:, 0], c_alt,
                              c_alt_lp))
            del low
        del ref
    return prog, ctl


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        t_process: float, rehearse: bool = False, control: bool = False,
        marks: Optional[dict] = None) -> dict:
    """One run; returns the result line's object (as ``runner.run``)."""
    if cell.chips != 1 or cell.config.get("mesh"):
        raise ValueError(f"{cell.name}: the generation server runs on one "
                         f"card, with no mesh")
    from a_nice_rag_tpu_torch.serving import genserver

    cfg = rehearsal_config(cell.config) if rehearse else cell.config
    traffic = dict(cell.traffic)
    if traffic["loop"] != "closed":
        raise ValueError(f"traffic loop {traffic['loop']!r}: the generation "
                         f"driver runs closed loops only")
    if rehearse:
        traffic.update(cfg.get("rehearsal_traffic", {}))
    device = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    lm, srv_cfg = cfg["lm"], cfg["server"]
    clients = traffic["clients"]
    k = int(srv_cfg["logprob_topk"])
    if k < 1:
        raise ValueError("the check reads the top K: logprob_topk >= 1")
    arch = arch_of(cell, cfg)
    info = {}
    marks = info["setup_marks"] = dict(marks or {})

    def mark(name):
        marks[name] = time.perf_counter() - t_process

    mark("imports")
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        mark("cuda")
    prefix, pool, budgets = prompts(traffic, lm["vocab_size"], genserver.PAD,
                                    seed)
    model = arch.program(lm, arch.weights(lm, seed, device), device,
                         cfg["dtype"])
    mark("weights")
    server = genserver.GenerationServer(
        model, slots=srv_cfg["slots"], max_len=srv_cfg["max_len"],
        chunk=srv_cfg["chunk"], eos_id=NO_TOKEN, seed=seed,
        min_prefill_bucket=srv_cfg["min_prefill_bucket"],
        prefill_chunk=srv_cfg["prefill_chunk"],
        logprob_topk=k, retain_prefixes=srv_cfg["retain_prefixes"])
    if prefix:
        server.cache_prefix(prefix)
    server.start()
    users = Clients(server, pool, budgets)
    mark("server")
    # Each prefill shape once, with a budget that ends after one decode
    # chunk.
    g = make_generator("cpu", seed, "warm-ids")
    warm = [prefix + token_ids(g, n - len(prefix), lm["vocab_size"],
                               genserver.PAD)
            for n in warm_lengths(traffic)]
    threads = [threading.Thread(target=users.ask,
                                args=(0, p, srv_cfg["chunk"] + 1))
               for p in warm]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    mark("warm")
    setup_s = marks["warm"]

    before = server.stats()
    prof = start_profile() if traced else None
    t0 = time.perf_counter()
    answers = users.drive(clients, seconds)
    t1 = max(a.end for a in answers)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    after = server.stats()
    stats = {name: after[name] - before[name]
             for name in ("ticks", "tokens_emitted", "prefix_cache_hits")}
    stats["prompt_tokens"] = sum(len(pool[a.index]) for a in answers)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    server.stop()

    whole = [a for a in answers if a.error is None]
    lat = np.array([(a.end - a.start) * 1e3 for a in answers])
    ttft = np.array([(a.first - a.start) * 1e3 for a in whole
                     if a.first is not None])
    e2e = {"qps": len(answers) / (t1 - t0),
           "p50_ms": float(np.percentile(lat, 50)),
           "p95_ms": float(np.percentile(lat, 95)),
           "setup_s": setup_s}
    info.update(
        ttft_ms={"p50": float(np.percentile(ttft, 50)),
                 "p95": float(np.percentile(ttft, 95))} if len(ttft) else None,
        output_tokens_per_s=sum(len(a.tokens) for a in answers) / (t1 - t0),
        ticks_per_s=stats["ticks"] / window_s, window=stats,
        window_s=window_s)

    layer, extra = {}, {}
    if prof is not None:
        layer, extra = traced_window(prof, cell, cfg, window_s, stats)
        del prof

    # The program's state goes before the reference runs, which makes the
    # weights again from the seed.
    del server, model, users
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    state = arch.weights(lm, seed, device)
    picks = sample_answers(answers, pool, traffic["check_requests"], seed)
    numbers = {"missing": float(len(answers) - len(whole)),
               "length_err": float(sum(
                   len(a.tokens) != a.budget
                   or len(a.req.logprobs) != a.budget
                   or len(a.req.top_logprobs) != a.budget
                   for a in whole))}
    prog, ctl = judge(arch, lm, state, pool, picks, k, device,
                      control=control)
    numbers.update(prog)
    del state
    limits = cfg["limits"]
    if control:
        info["control"] = ctl
        info["control_correct"] = verdict(
            {n: v for n, v in (ctl or {}).items() if n in limits}, limits)
        info["program"] = dict(numbers)
    info["judged"] = len(picks)
    numbers = {n: numbers[n] for n in limits if n in numbers}
    ok = bool(picks) and verdict(numbers, limits) \
        and set(numbers) == set(limits)
    return result_line(
        cell, ok=ok, attempted=len(answers), failed=len(answers) - len(whole),
        rehearse=rehearse, traced=traced, e2e=e2e, layer=layer, extra=extra,
        peak=peak, device=device, info=info, numbers=numbers, limits=limits)
