"""The port's serving path against the JAX package's: prefill and the
KV cache, decode steps, the engine and the serve CLI.

Both engines run over the same parameters (the reference's
``model.init(jax.random.PRNGKey(0))`` at ``reduced_for_smoke``, carried
across by ``params_from_numpy`` onto the CPU) and the same prompts from
``np.random.default_rng(seed)``: the generated tokens and ``steps`` must
be equal. Logits compared directly agree within ``ATOL``/``RTOL``
(float32 on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as ref_archs
from repro.configs import reduced_for_smoke as ref_reduced
from repro.models.model import build_model as ref_build_model
from repro.serving.engine import ServingEngine as RefEngine

from repro_torch.configs import all_archs, reduced_for_smoke
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serving.engine import GenerationResult, ServingEngine

pytestmark = pytest.mark.tier1

ATOL = RTOL = 1e-5


def pair(arch, **changes):
    rcfg = dataclasses.replace(ref_reduced(ref_archs()[arch]), **changes)
    tcfg = dataclasses.replace(reduced_for_smoke(all_archs()[arch]),
                               **changes)
    ref = ref_build_model(rcfg)
    params, _ = ref.init(jax.random.PRNGKey(0))
    port = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return ref, params, port


def prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in lengths]


def assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, GenerationResult)
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert (g.prompt_len, g.steps) == (w.prompt_len, w.steps)


# the 7 ported configs; the gather dispatch's prefill and decode run
# through the engine cases below
PORTED = ["qwen2-1.5b", "chatglm3-6b", "codeqwen1.5-7b", "phi4-mini-3.8b",
          "chameleon-34b", "granite-moe-1b-a400m", "olmoe-1b-7b"]


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


def assert_close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def ref_cache_layer(cache, cfg, i, kv):
    plen = len(cfg.block_pattern)
    return cache["stack"][f"pos{i % plen}"][kv][i // plen]


# -- the KV cache: prefill and decode steps against the reference ------------

@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_reference(arch):
    """prefill's last logits and cache, then 4 decode steps' logits and
    the cache they leave."""
    ref, params, port = pair(arch)
    cfg = port.cfg
    b, s_prompt, steps, max_seq = 2, 6, 4, 12
    toks = tokens(cfg.vocab_size, (b, s_prompt + steps), seed=2)
    ref_prefill = jax.jit(lambda p, x: ref.prefill(p, x, max_seq=max_seq))
    ref_decode = jax.jit(ref.decode_step)

    want, rcache = ref_prefill(params, jnp.asarray(toks[:, :s_prompt]))
    got, cache = port.prefill(t(toks[:, :s_prompt]), max_seq=max_seq)
    assert got.shape == (b, 1, cfg.vocab_size)
    assert_close(got, want)
    for kv in ("k", "v"):
        assert cache[kv].shape == (cfg.num_layers, b, max_seq,
                                   cfg.num_kv_heads, cfg.resolved_head_dim)
        for i in range(cfg.num_layers):
            assert_close(cache[kv][i], ref_cache_layer(rcache, cfg, i, kv))

    for pos in range(s_prompt, s_prompt + steps):
        tok = toks[:, pos:pos + 1]
        want, rcache = ref_decode(params, rcache, jnp.asarray(tok),
                                  jnp.int32(pos))
        got, cache = port.decode_step(cache, t(tok), pos)
        assert_close(got, want)
    for kv in ("k", "v"):
        for i in range(cfg.num_layers):
            assert_close(cache[kv][i], ref_cache_layer(rcache, cfg, i, kv))


# -- the engine ---------------------------------------------------------------

# (arch, dispatch, prompt lengths, batch slots)
GENERATE = [
    ("qwen2-1.5b", "einsum", [6], 1),
    ("qwen2-1.5b", "einsum", [7, 3, 5], 4),
    ("phi4-mini-3.8b", "einsum", [4, 9], 2),
    ("chatglm3-6b", "einsum", [5, 5], 2),
    ("granite-moe-1b-a400m", "einsum", [8, 2, 6], 3),
    ("granite-moe-1b-a400m", "gather", [8, 2, 6], 3),
    ("olmoe-1b-7b", "gather", [3, 10], 2),
]


@pytest.mark.parametrize("arch,dispatch,lengths,slots", GENERATE)
def test_generate_matches_reference(arch, dispatch, lengths, slots):
    """Left padding, greedy argmax and the steps count, with prompts of
    equal and unequal lengths and empty batch slots."""
    ref, params, port = pair(arch, moe_dispatch=dispatch)
    ps = prompts(port.cfg.vocab_size, lengths)
    want = RefEngine(ref, params, max_batch=slots, max_seq=24) \
        .generate(ps, max_new_tokens=8)
    got = ServingEngine(port, max_batch=slots, max_seq=24) \
        .generate(ps, max_new_tokens=8)
    assert_same_results(got, want)
    assert all(r.steps == 8 for r in got)


@pytest.mark.parametrize("lengths", [[6], [7, 3, 5]])
def test_generate_with_eos_matches_reference(lengths):
    """With ``eos_id`` a token that request 0 emits at its third step:
    each request's tokens end at its first EOS; a single request stops
    the loop there, a batch only once every request has emitted it."""
    ref, params, port = pair("qwen2-1.5b")
    ps = prompts(port.cfg.vocab_size, lengths, seed=1)
    free = ServingEngine(port, max_batch=len(ps), max_seq=24) \
        .generate(ps, max_new_tokens=8)
    eos = int(free[0].tokens[2])
    want = RefEngine(ref, params, max_batch=len(ps), max_seq=24,
                     eos_id=eos).generate(ps, max_new_tokens=8)
    got = ServingEngine(port, max_batch=len(ps), max_seq=24,
                        eos_id=eos).generate(ps, max_new_tokens=8)
    assert_same_results(got, want)
    assert got[0].tokens[-1] == eos
    assert len(got[0].tokens) == list(free[0].tokens).index(eos) + 1
    if len(ps) == 1:
        assert got[0].steps == len(got[0].tokens) < 8


def test_generate_matches_stepwise_forward():
    """Engine output == the argmax chain of full forward passes over the
    growing sequence (tests/test_serving.py's check, on the port)."""
    model = build_model(reduced_for_smoke(all_archs()["qwen2-1.5b"]),
                        device="cpu")
    prompt = prompts(model.cfg.vocab_size, [6])[0]
    res = ServingEngine(model, max_batch=1, max_seq=24) \
        .generate([prompt], max_new_tokens=5)[0]
    seq = list(prompt)
    with torch.inference_mode():
        for _ in range(5):
            logits, _ = model(torch.tensor([seq]))
            seq.append(int(torch.argmax(logits[0, -1])))
    np.testing.assert_array_equal(res.tokens, np.asarray(seq[6:]))


def test_generate_batch_isolated():
    """Requests in one batch do not contaminate each other."""
    model = build_model(reduced_for_smoke(all_archs()["qwen2-1.5b"]),
                        device="cpu")
    p1, p2 = prompts(model.cfg.vocab_size, [5, 5], seed=1)
    both = ServingEngine(model, max_batch=2, max_seq=16) \
        .generate([p1, p2], max_new_tokens=4)
    solo = ServingEngine(model, max_batch=2, max_seq=16) \
        .generate([p1, p1], max_new_tokens=4)
    np.testing.assert_array_equal(both[0].tokens, solo[0].tokens)


def test_engine_rejects_what_does_not_fit():
    import repro_torch.serving as package
    assert package.ServingEngine is ServingEngine
    assert package.GenerationResult is GenerationResult
    model = build_model(reduced_for_smoke(all_archs()["qwen2-1.5b"]),
                        device="cpu")
    engine = ServingEngine(model, max_batch=2, max_seq=12)
    ps = prompts(model.cfg.vocab_size, [5, 5, 5])
    with pytest.raises(ValueError, match="batch slots"):
        engine.generate(ps)
    with pytest.raises(ValueError, match="max_seq"):
        engine.generate(ps[:2], max_new_tokens=8)


def test_prefill_logits_match_reference_engine_path():
    """The engine's first token comes from prefill's last logits on the
    left-padded batch; those logits equal the reference's."""
    ref, params, port = pair("granite-moe-1b-a400m")
    toks = np.zeros((2, 7), np.int32)
    for i, p in enumerate(prompts(port.cfg.vocab_size, [7, 4])):
        toks[i, 7 - len(p):] = p
    want, _ = ref.prefill(params, jnp.asarray(toks), max_seq=16)
    with torch.inference_mode():
        got, _ = port.prefill(torch.as_tensor(toks.astype(np.int64)),
                              max_seq=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m"])
def test_serve_cli_runs_on_cpu(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--batch", "2",
                "--new-tokens", "4", "--max-seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-smoke: batch=2" in out
    assert "[serve] 8 tokens in " in out and "tok/s on cpu)" in out
    assert out.count("generated=") == 2
