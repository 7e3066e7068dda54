"""The port's language-model decoders against the JAX package's: the
config registry, the full-sequence forward, chunked attention, both MoE
dispatches, the layers and the weight converter; and the port's own
decode-vs-forward consistency.

The reference's parameters come from ``model.init(jax.random.PRNGKey(0))``
at ``reduced_for_smoke``, go through ``params_from_numpy`` and land in
the port's model on the CPU; tokens come from
``np.random.default_rng(seed)``. Both sides compute in float32, and every
logit and MoE output agrees within ``ATOL``/``RTOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as ref_archs
from repro.configs import reduced_for_smoke as ref_reduced
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro.models.model import build_model as ref_build_model

from repro_torch.configs import all_archs, reduced_for_smoke
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model

pytestmark = pytest.mark.tier1

# float32 on both sides, same weights and inputs.
ATOL = RTOL = 1e-5

DENSE = ["qwen2-1.5b", "chatglm3-6b", "codeqwen1.5-7b", "phi4-mini-3.8b",
         "chameleon-34b"]
MOE = ["granite-moe-1b-a400m", "olmoe-1b-7b"]
PORTED = DENSE + MOE
# every ported config, and the MoE ones with the gather dispatch too
CASES = ([(a, "einsum") for a in PORTED]
         + [(a, "gather") for a in MOE])


def configs(arch, **changes):
    """The smoke-size config of ``arch`` in both packages."""
    return (dataclasses.replace(ref_reduced(ref_archs()[arch]), **changes),
            dataclasses.replace(reduced_for_smoke(all_archs()[arch]),
                                **changes))


def pair(arch, **changes):
    """The reference model with its parameters, and the port's model on
    the CPU holding the same parameters."""
    rcfg, tcfg = configs(arch, **changes)
    ref = ref_build_model(rcfg)
    params, _ = ref.init(jax.random.PRNGKey(0))
    port = params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return ref, params, port


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


def assert_close(got, want):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# -- the registry ------------------------------------------------------------

def test_registry_has_the_reference_names():
    assert sorted(all_archs()) == sorted(ref_archs())
    assert len(all_archs()) == 10


@pytest.mark.parametrize("arch", sorted(ref_archs()))
def test_param_count_matches_reference(arch):
    ref, port = ref_archs()[arch], all_archs()[arch]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert reduced_for_smoke(port).param_count() == \
        ref_reduced(ref).param_count()


# -- whole model against the reference ----------------------------------------

@pytest.mark.parametrize("arch,dispatch", CASES)
def test_forward_matches_reference(arch, dispatch):
    ref, params, port = pair(arch, moe_dispatch=dispatch)
    toks = tokens(port.cfg.vocab_size, (2, 9))
    want, want_aux = jax.jit(ref.forward)(params, jnp.asarray(toks))
    got, got_aux = port(t(toks))
    assert got.shape == (2, 9, port.cfg.vocab_size)
    assert_close(got, want)
    assert_close(got_aux, want_aux)
    hid, _ = port.hidden(t(toks))
    assert torch.equal(port.embed.unembed(hid), got)


# -- the chunked-attention branch ------------------------------------------------

CHUNK, THRESHOLD = 4, 8


@pytest.mark.parametrize("s,chunked", [(16, True), (14, False)])
def test_chunked_attention_matches_reference(monkeypatch, s, chunked):
    """Above the threshold with S a multiple of the chunk, both packages
    loop over query chunks; with S not a multiple they fall back to the
    whole score matrix. The reference binds ``chunk``'s default when its
    functions are defined, so the test sets those defaults too."""
    monkeypatch.setattr(RL, "ATTN_CHUNK_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(RL, "ATTN_CHUNK", CHUNK)
    for fn in (RL.attention, RL.attention_with_kv):
        monkeypatch.setattr(fn, "__defaults__", (CHUNK, True))
    monkeypatch.setattr(TL, "ATTN_CHUNK_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(TL, "ATTN_CHUNK", CHUNK)
    calls = []
    scores = TL.gqa_scores
    monkeypatch.setattr(TL, "gqa_scores",
                        lambda q, k, h: calls.append(q.shape[1])
                        or scores(q, k, h))

    ref, params, port = pair("qwen2-1.5b")
    toks = tokens(port.cfg.vocab_size, (2, s), seed=3)
    want, _ = ref.forward(params, jnp.asarray(toks))
    got, _ = port(t(toks))
    assert_close(got, want)
    layers = port.cfg.num_layers
    assert calls == ([CHUNK] * (s // CHUNK) * layers if chunked
                     else [s] * layers)
    want, _ = ref.prefill(params, jnp.asarray(toks), max_seq=s + 2)
    got, _ = port.prefill(t(toks), max_seq=s + 2)
    assert_close(got, want)


def test_chunked_attention_equals_whole(monkeypatch):
    """The port's chunked branch computes what its whole-matrix branch
    does."""
    _, _, port = pair("olmoe-1b-7b")
    toks = t(tokens(port.cfg.vocab_size, (2, 16), seed=4))
    whole, _ = port(toks)
    monkeypatch.setattr(TL, "ATTN_CHUNK_THRESHOLD", THRESHOLD)
    monkeypatch.setattr(TL, "ATTN_CHUNK", CHUNK)
    chunked, _ = port(toks)
    assert_close(chunked, whole.numpy())


# -- MoE dispatch ----------------------------------------------------------------

def _overflow(probs, k, e, capacity):
    """Most (token, choice) pairs any expert receives beyond capacity."""
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    return np.bincount(top.ravel(), minlength=e).max() - capacity


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
def test_moe_dispatch_matches_reference(dispatch, capacity_factor):
    """Each dispatch against the reference's same dispatch. At capacity
    factor 1.25 tokens drop (asserted), so equal outputs show that the
    same tokens were dropped; at 4.0 (the smoke configs') none can."""
    rcfg, tcfg = configs("granite-moe-1b-a400m", moe_dispatch=dispatch)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity_factor))
    params, _ = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    blk = jax.tree.map(lambda p: np.asarray(p[0]),
                       params["stack"]["pos0"]["ffn"])
    port = TMOE.MoE(tcfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(np.array(blk[name])))
    x = np.random.default_rng(0).normal(size=(2, 32, tcfg.d_model)) \
        .astype(np.float32)

    m = tcfg.moe
    t_ = x.shape[0] * x.shape[1]
    logits = x.reshape(t_, -1) @ blk["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    overflow = _overflow(probs, m.experts_per_token, m.num_experts,
                         max(int(capacity_factor * t_ * m.experts_per_token
                                 / m.num_experts), 1))
    assert (overflow > 0) == (capacity_factor < 2.0)

    want, want_aux = RMOE.moe_ffn_with_aux(blk, jnp.asarray(x), rcfg)
    got, got_aux = port(torch.from_numpy(x))
    assert_close(got, want)
    assert_close(got_aux, want_aux)


# -- the port's own consistency (tests/test_models_numerics.py) ------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b",
                                  "granite-moe-1b-a400m"])
def test_decode_matches_forward(arch):
    """Decoding token by token from an empty cache reproduces the full
    forward pass (teacher forcing)."""
    model = build_model(reduced_for_smoke(all_archs()[arch]), device="cpu")
    b, s = 2, 8
    toks = t(tokens(model.cfg.vocab_size, (b, s), seed=6))
    full, _ = model(toks)
    cache = model.init_cache(b, s)
    steps = [model.decode_step(cache, toks[:, i:i + 1], i)[0][:, 0]
             for i in range(s)]
    assert_close(torch.stack(steps, dim=1), full.numpy())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi4-mini-3.8b",
                                  "olmoe-1b-7b"])
def test_prefill_then_decode_matches_forward(arch):
    """prefill(prompt) + decode steps == forward over the whole
    sequence: the cache-seeding path the serving engine uses."""
    model = build_model(reduced_for_smoke(all_archs()[arch]), device="cpu")
    b, s_prompt, s_total = 2, 5, 9
    toks = t(tokens(model.cfg.vocab_size, (b, s_total), seed=7))
    full, _ = model(toks)
    last, cache = model.prefill(toks[:, :s_prompt], max_seq=s_total)
    assert_close(last[:, 0], full[:, s_prompt - 1].numpy())
    for i in range(s_prompt, s_total):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        assert_close(lg[:, 0], full[:, i].numpy())


# -- layers and the converter ------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    assert_close(TL.rms_norm(torch.from_numpy(scale), torch.from_numpy(x),
                             1e-5),
                 RL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                             1e-5))
    pos = np.stack([np.arange(5), np.arange(100, 105)])
    assert_close(TL.apply_rope(torch.from_numpy(x), t(pos), 16),
                 RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 16))


def test_random_init_is_seeded_and_has_the_reference_scales():
    cfg = reduced_for_smoke(all_archs()["phi4-mini-3.8b"])
    a = build_model(cfg, device="cpu")
    b = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    c = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(p, q), name
        if p.dim() >= 2:
            assert not torch.equal(p, r), name
    layer = a.stack.layers[0]
    assert torch.equal(layer.norm1, torch.ones(cfg.d_model))
    assert abs(a.embed.tok.std().item() - 0.02) < 0.002
    assert abs(layer.ffn.w_down.std().item() * cfg.d_ff ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_convert_rejects_a_tree_that_does_not_fit(fault):
    rcfg, tcfg = configs("qwen2-1.5b")
    params, _ = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    ffn = tree["stack"]["pos0"]["ffn"]
    if fault == "missing":
        del ffn["w_up"]
    elif fault == "extra":
        tree["embed"]["out"] = tree["embed"]["tok"].T
    else:
        ffn["w_up"] = ffn["w_up"][:, :, :-1]
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        params_from_numpy(tcfg, tree, device="cpu")
