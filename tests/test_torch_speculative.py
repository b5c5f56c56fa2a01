"""The port's speculative decoding (a_nice_rag_tpu_torch/models/
speculative.py) against the JAX package's, on the CPU.

Mirrors tests/test_speculative.py: the greedy speculative stream equals
the target's plain greedy stream and the JAX package's speculative
stream token for token (the JAX package's weights carried across with
``decoder_state_dict``), whatever the draft; ``spec_accept`` returns the
JAX package's counts and tokens under its own uniform and Gumbel draws,
and preserves the target distribution over 40,000 trials (each
probability within 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a_nice_rag_tpu.models import decoder as jd
from a_nice_rag_tpu.models import speculative as js
from a_nice_rag_tpu_torch.models import decoder as td
from a_nice_rag_tpu_torch.models.convert import (
    decoder_state_dict,
    load_decoder_state,
)
from a_nice_rag_tpu_torch.models.speculative import (
    spec_accept,
    speculative_generate_stream,
)

DRAFT = dict(hidden_size=64, num_layers=1)


def _port(params, **cfg):
    return load_decoder_state(td.small_lm_config(**cfg),
                              decoder_state_dict(jax.device_get(params)),
                              device="cpu")


@pytest.fixture(scope="module")
def models():
    target, tp = jd.init_decoder(jd.small_lm_config())
    draft, dp = jd.init_decoder(jd.small_lm_config(**DRAFT), seed=9)
    return (target, tp, _port(tp)), (draft, dp, _port(dp, **DRAFT))


def test_speculative_matches_greedy_independent_draft(models):
    """A draft that knows nothing about the target still yields the
    target's exact greedy stream, and the JAX package's."""
    (target, tp, t), (draft, dp, d) = models
    prompt = list(range(10, 30))
    ref = list(td.generate_stream(t, prompt, max_new_tokens=40))
    stats = {}
    got = list(speculative_generate_stream(t, d, prompt, max_new_tokens=40,
                                           gamma=4, stats=stats))
    assert got == ref == list(js.speculative_generate_stream(
        target, tp, draft, dp, prompt, max_new_tokens=40, gamma=4))
    assert 1 <= stats["rounds"] <= stats["accepted"]


def test_speculative_accepts_when_draft_agrees():
    """A trained model (the JAX package's train_lm_steps, carried across)
    drafting for itself accepts nearly every proposal: mean tokens/round
    above 3 at gamma 4, and the stream is the plain greedy one."""
    tok = jd.ByteTokenizer()
    phrase = "the dose is 42 mg daily. "
    ids = tok.encode(phrase * 6)
    cfg = jd.small_lm_config(hidden_size=96, num_layers=2)
    model, params = jd.init_decoder(cfg, seed=1, max_len=len(ids))
    params, _ = jd.train_lm_steps(
        model, params, jnp.asarray(ids, jnp.int32)[None, :], n_steps=150)
    port = _port(params, hidden_size=96, num_layers=2)
    prompt = tok.encode(phrase * 2)
    ref = list(td.generate_stream(port, prompt, max_new_tokens=30))
    stats = {}
    got = list(speculative_generate_stream(port, port, prompt,
                                           max_new_tokens=30, gamma=4,
                                           stats=stats))
    assert got == ref
    assert stats["accepted"] / stats["rounds"] > 3.0, stats


def test_speculative_eos_stops_stream(models):
    (_, _, t), (_, _, d) = models
    prompt = [256, 9, 17, 33]
    ref = list(td.generate_stream(t, prompt, max_new_tokens=24))
    fake_eos = ref[7]
    a = list(td.generate_stream(t, prompt, max_new_tokens=24,
                                eos_id=fake_eos))
    b = list(speculative_generate_stream(t, d, prompt, max_new_tokens=24,
                                         gamma=4, eos_id=fake_eos))
    assert a == b and fake_eos not in b and len(b) < len(ref)


def test_spec_accept_under_jax_draws():
    """Given the JAX package's uniform and Gumbel draws for its key, the
    port's spec_accept returns its tokens and counts, on random draft and
    target distributions."""
    rng = np.random.default_rng(4)
    gamma, v = 4, 12
    for s in range(20):
        qs = rng.dirichlet(np.ones(v), gamma).astype(np.float32)
        ps = rng.dirichlet(np.ones(v) * 0.5, gamma).astype(np.float32)
        ds = rng.integers(0, v, gamma).astype(np.int32)
        bonus = rng.normal(size=(1, v)).astype(np.float32)
        key = jax.random.PRNGKey(s)
        want, want_m = js.spec_accept(jnp.asarray(ds), jnp.asarray(qs),
                                      jnp.asarray(ps), jnp.asarray(bonus),
                                      key)
        k_u, k_rep, k_bonus = jax.random.split(key, 3)
        draws = [torch.tensor(np.asarray(x)) for x in (
            jax.random.uniform(k_u, (gamma,)),
            jax.random.gumbel(k_rep, (gamma, v)),
            jax.random.gumbel(k_bonus, (1, v)))]
        got, got_m = spec_accept(torch.as_tensor(ds).long(),
                                 torch.as_tensor(qs), torch.as_tensor(ps),
                                 torch.as_tensor(bonus), draws)
        assert int(got_m) == int(want_m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_accept_preserves_target_distribution():
    """The rejection-sampling core over 40,000 independent rows with a
    fixed draft distribution q and target p: the emitted token's
    marginal is p within 0.01."""
    v, n = 6, 40_000
    p = torch.tensor([0.35, 0.05, 0.2, 0.1, 0.25, 0.05])
    q = torch.tensor([0.10, 0.30, 0.2, 0.2, 0.15, 0.05])
    g = torch.Generator().manual_seed(0)
    d = torch.multinomial(q, n, replacement=True, generator=g)[:, None]
    out, _ = spec_accept(d, q.expand(n, 1, v), p.expand(n, 1, v),
                         torch.log(p).expand(n, 1, v), g)
    emp = torch.bincount(out[:, 0], minlength=v).float() / n
    assert float((emp - p).abs().max()) < 0.01, emp


def test_speculative_sampled_mode_runs_and_accepts(models):
    """Sampled speculation with a self-draft accepts most proposals (p ==
    q up to cross-shape numerics) and respects the budget."""
    (_, _, t), _ = models
    stats = {}
    s = list(speculative_generate_stream(
        t, t, list(range(10, 30)), max_new_tokens=40, gamma=4,
        temperature=0.9, top_k=50, seed=3, stats=stats))
    assert len(s) == 40
    assert stats["accepted"] / stats["rounds"] > 2.0, stats


def test_speculative_multi_round_dispatch(models):
    """rounds=R runs R speculation rounds per host read; the stream stays
    the plain greedy one, EOS raised mid-block included."""
    (_, _, t), (_, _, d) = models
    prompt = list(range(10, 30))
    ref = list(td.generate_stream(t, prompt, max_new_tokens=30))
    assert list(speculative_generate_stream(
        t, d, prompt, max_new_tokens=30, gamma=4, rounds=3)) == ref
    e = ref[7]
    a = list(td.generate_stream(t, prompt, max_new_tokens=30, eos_id=e))
    b = list(speculative_generate_stream(t, d, prompt, max_new_tokens=30,
                                         gamma=4, rounds=3, eos_id=e))
    assert a == b
