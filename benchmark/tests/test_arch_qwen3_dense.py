"""``archs/qwen3_dense.py``'s plain reference against the port's
``DecoderLM`` on seeded weights at a small size on the CPU: the full
forward, and prefill then decode through the cache."""

import ast

import pytest
import torch

from benchmark.harness.spec import BENCH_DIR, load_module

from a_nice_rag_tpu_torch.models.decoder import init_caches, lm_logits

ARCH_FILE = BENCH_DIR / "archs" / "qwen3_dense.py"
arch = load_module(ARCH_FILE, "benchmark_arch_")

# Two layers at a logit spread near the published model's (weights
# 0.125 / sqrt(64) of hidden 64, as 0.02 of 2048: logits of spread ~1).
LM = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=16, intermediate_size=128,
          vocab_size=512, tie_word_embeddings=True, rope_theta=1e6,
          rms_norm_eps=1e-6, initializer_range=0.125, torch_dtype="float32")
SEED = 2**31 + 5
# float32 on both sides, the same operations in another order: sums of
# at most 128 products and a log-softmax over 512 logits near 6 in size
# differ by a few ulps of float32 (2^-23 x 8 ~ 1e-6 each).
F32_TOL = 2e-5
# bfloat16 compute (8-bit significands) through two layers, over every
# entry of each row: the sound program reads 0.067-0.088 on these seeds,
# fp8 inputs to every matmul (the control) 0.78-0.87.
BF16_TOL = 0.25


def _ids(n, seed=0):
    return torch.randint(0, LM["vocab_size"],
                         (n,), generator=torch.Generator().manual_seed(seed))


def _decoded(model, ids, prefill):
    """Log-probabilities of positions prefill-1 .. S-2 through the cache:
    one prefill of the first ``prefill`` ids, then one step an id."""
    s = ids.shape[0]
    kc, vc = init_caches(model.cfg, 1, s, "cpu")
    rows = []
    with torch.no_grad():
        logits, kc, vc = model(ids[None, :prefill], kc, vc, 0)
        rows.append(logits[0, -1])
        for p in range(prefill, s - 1):
            logits, kc, vc = model(ids[None, p:p + 1], kc, vc,
                                   torch.tensor([p]))
            rows.append(logits[0, -1])
    return torch.log_softmax(torch.stack(rows).float(), dim=-1)


def test_full_forward_matches_in_float32():
    state = arch.weights(LM, SEED, "cpu")
    model = arch.program(LM, state, "cpu", "float32")
    ids = _ids(48)
    ref = arch.reference_logprobs(LM, state, ids)
    got = torch.log_softmax(lm_logits(model, ids[None])[0], dim=-1)
    assert (got - ref).abs().max() < F32_TOL


@pytest.mark.parametrize("prefill", [1, 17, 40])
def test_prefill_then_decode_matches_in_float32(prefill):
    state = arch.weights(LM, SEED, "cpu")
    model = arch.program(LM, state, "cpu", "float32")
    ids = _ids(48, seed=prefill)
    n = ids.shape[0] - prefill
    ref = arch.reference_logprobs(LM, state, ids[:-1], last=n)
    assert (_decoded(model, ids, prefill) - ref).abs().max() < F32_TOL


@pytest.mark.parametrize("seed", [3, SEED])
def test_bf16_within_its_tolerance_and_the_control_beyond(seed):
    lm = dict(LM, torch_dtype="bfloat16")
    state = arch.weights(lm, seed, "cpu")
    model = arch.program(lm, state, "cpu", "bfloat16")
    ids = _ids(64, seed=seed)
    ref = arch.reference_logprobs(lm, state, ids[:-1], last=40)
    assert (_decoded(model, ids, 24) - ref).abs().max() < BF16_TOL
    low = arch.reference_logprobs(lm, state, ids[:-1], control=True, last=40)
    assert (low - ref).abs().max() > BF16_TOL


def test_weights_follow_the_seed():
    a = arch.weights(LM, SEED, "cpu")
    b = arch.weights(LM, SEED, "cpu")
    c = arch.weights(LM, SEED + 1, "cpu")
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed_tokens.weight"], c["embed_tokens.weight"])
    assert all(v.dtype == torch.float32 for v in a.values())
    model = arch.program(LM, a, "cpu", "float32")
    # The program serves the state's own tensors.
    assert model.embed_tokens.weight.data_ptr() == \
        a["embed_tokens.weight"].data_ptr()


def _imports(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Import):
            yield from (a.name.split(".")[0] for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            yield n.module.split(".")[0]


def test_only_program_imports_the_port():
    tree = ast.parse(ARCH_FILE.read_text())
    top = {n for s in tree.body if isinstance(s, (ast.Import, ast.ImportFrom))
           for n in _imports(s)}
    assert top <= {"__future__", "math", "typing", "torch", "benchmark"}
    funcs = {f.name: set(_imports(f)) for f in tree.body
             if isinstance(f, ast.FunctionDef)}
    assert funcs["program"] == {"a_nice_rag_tpu_torch"}
    assert all(not names for name, names in funcs.items()
               if name != "program")
