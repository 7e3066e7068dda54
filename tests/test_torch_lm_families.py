"""The port's RWKV, Mamba-hybrid and encoder-decoder families against the
JAX package's: the WKV6 scans and the selective scan, the blocks, the
whole models' forward, prefill cache and decode steps, the engine and
the serve CLI; the port's own decode-vs-forward consistency
(tests/test_models_numerics.py), their loss and every gradient leaf
against ``jax.grad``, and one train step of every config
(tests/test_models_smoke.py).

The reference's parameters come from ``model.init(jax.random.PRNGKey(0))``
at ``reduced_for_smoke`` and go through ``params_from_numpy`` onto the
CPU; inputs come from ``np.random.default_rng(seed)``. Both sides compute
in float32: activations and logits agree within ``ATOL``/``RTOL``, each
gradient leaf within ``GRAD_RTOL`` of its largest absolute value. The
WKV and decode-vs-forward checks of the port against itself keep the
reference tests' tolerances.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as ref_archs
from repro.configs import reduced_for_smoke as ref_reduced
from repro.models import mamba as RM
from repro.models import rwkv as RR
from repro.models.model import build_model as ref_build_model
from repro.serving.engine import ServingEngine as RefEngine

from repro_torch.configs import all_archs, reduced_for_smoke
from repro_torch.launch import serve
from repro_torch.models import mamba as TM
from repro_torch.models import rwkv as TR
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model, build_model
from repro_torch.serving.engine import ServingEngine

pytestmark = pytest.mark.tier1

# float32 on both sides, same weights and inputs
ATOL = RTOL = 1e-5
GRAD_RTOL = 1e-4
# the reference tests' tolerances for two algorithms in the port
WKV_TOL = 2e-4          # chunked against sequential WKV
STEP_TOL = 2e-3         # decode steps against the full forward

FAMILIES = ["rwkv6-7b", "jamba-1.5-large-398b", "seamless-m4t-medium"]

_PAIRS = {}


@pytest.fixture(autouse=True)
def _scan_unroll_one(monkeypatch):
    """The reference's selective scan unrolls 16 steps per iteration,
    which only lays out the loop for the TPU and multiplies its compile
    time here; its values are the same at 1."""
    monkeypatch.setattr(RM, "SCAN_UNROLL", 1)


def pair(arch):
    """The reference model, its parameters, and the port's model on the
    CPU holding the same parameters (built once per arch)."""
    if arch not in _PAIRS:
        ref = ref_build_model(ref_reduced(ref_archs()[arch]))
        params = jax.jit(lambda key: ref.init(key)[0])(
            jax.random.PRNGKey(0))
        _PAIRS[arch] = (ref, params, jax.tree.map(np.asarray, params))
    ref, params, tree = _PAIRS[arch]
    port = params_from_numpy(reduced_for_smoke(all_archs()[arch]), tree,
                             device="cpu")
    return ref, params, port


def rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def t(x):
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype.kind in "iu"
                           else x)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def enc_input(cfg, b=2, f=5, seed=2):
    return np.random.default_rng(seed).normal(size=(b, f, cfg.d_model)) \
        .astype(np.float32)


# -- WKV6 ----------------------------------------------------------------------

def wkv_inputs(seed, b, s, h, n):
    r, k, v, lw = rng_arrays(seed, *[(b, s, h, n)] * 4)
    u, = rng_arrays(seed + 1, (h, n))
    return r, k, v, -np.abs(lw) - 0.01, u


@pytest.mark.parametrize("chunk", [1, 4, 8, 16])
@pytest.mark.parametrize("s", [8, 16, 33])
def test_wkv_chunked_matches_scan_and_reference(chunk, s):
    """The port's chunked WKV against its sequential oracle (the
    reference test's tolerance) and against the reference's chunked
    WKV (float32 parity)."""
    args = wkv_inputs(chunk * 100 + s, 2, s, 3, 4)
    o_ref, st_ref = TR.wkv_reference(*map(torch.from_numpy, args))
    o, st = TR.wkv_chunked(*map(torch.from_numpy, args), chunk)
    close(o, o_ref.numpy(), rtol=WKV_TOL, atol=WKV_TOL)
    if s % chunk == 0:  # a padded tail changes the final state
        close(st, st_ref.numpy(), rtol=WKV_TOL, atol=WKV_TOL)
    want_o, want_st = RR.wkv_chunked(*map(jnp.asarray, args), chunk)
    close(o, want_o)
    close(st, want_st)
    want_o, want_st = RR.wkv_reference(*map(jnp.asarray, args))
    close(o_ref, want_o)
    close(st_ref, want_st)


def test_wkv_step_matches_scan_and_reference():
    r, k, v, lw, u = map(torch.from_numpy, wkv_inputs(0, 1, 6, 2, 4))
    o_ref, st_ref = TR.wkv_reference(r, k, v, lw, u)
    state = torch.zeros(1, 2, 4, 4)
    jstate = jnp.zeros((1, 2, 4, 4), jnp.float32)
    for i in range(6):
        step = (r[:, i], k[:, i], v[:, i], lw[:, i], u)
        o, state = TR.wkv_step(*step, state)
        jo, jstate = RR.wkv_step(*(jnp.asarray(x.numpy()) for x in step),
                                 jstate)
        close(o, o_ref[:, i].numpy(), rtol=1e-4, atol=1e-4)
        close(o, jo)
        close(state, jstate)
    close(state, st_ref.numpy(), rtol=1e-4, atol=1e-4)


# -- the blocks ----------------------------------------------------------------

def block(params, arch, pos, layer=0):
    """One block's parameters of the reference (numpy) at period ``layer``
    of period position ``pos``."""
    return jax.tree.map(lambda p: np.asarray(p[layer]),
                        params["stack"][f"pos{pos}"])


def test_rwkv_time_and_channel_mix_match_reference():
    ref, params, port = pair("rwkv6-7b")
    cfg, rcfg = port.cfg, ref.cfg
    blk = block(params, "rwkv6-7b", 0)
    layer = port.stack.layers[0]
    x, = rng_arrays(3, (2, 11, cfg.d_model))
    out, (last, state) = TR.time_mix(layer.mixer, t(x), cfg)
    want, (wlast, wstate) = jax.jit(functools.partial(
        RR.time_mix, cfg=rcfg, return_state=True))(blk["mixer"],
                                                   jnp.asarray(x))
    close(out, want)
    close(last, wlast)
    close(state, wstate)
    close(TR.channel_mix(layer.ffn, t(x)),
          RR.channel_mix(blk["ffn"], jnp.asarray(x)))
    shift, = rng_arrays(4, (2, 1, cfg.d_model))
    close(TR.channel_mix(layer.ffn, t(x[:, :1]), t(shift)),
          RR.channel_mix(blk["ffn"], jnp.asarray(x[:, :1]),
                         jnp.asarray(shift)))
    got = TR.time_mix_decode(layer.mixer, t(x[:, :1]), cfg, t(shift),
                             state)
    want = jax.jit(functools.partial(RR.time_mix_decode, cfg=rcfg))(
        blk["mixer"], jnp.asarray(x[:, :1]), shift_state=jnp.asarray(shift),
        wkv_state=wstate)
    for g, w in zip(got, want, strict=True):
        close(g, w)


def test_mamba_block_matches_reference():
    ref, params, port = pair("jamba-1.5-large-398b")
    cfg, rcfg = port.cfg, ref.cfg
    blk = block(params, "jamba", 1)          # position 1: a Mamba block
    mixer = port.stack.layers[1].mixer
    assert isinstance(mixer, TM.Mamba)
    x, = rng_arrays(5, (2, 9, cfg.d_model))
    u_raw, *inputs = TM._ssm_inputs(mixer, t(x), cfg)
    want = jax.jit(functools.partial(RM._ssm_inputs, cfg=rcfg))(
        blk["mixer"], jnp.asarray(x))
    for g, w in zip(inputs, want, strict=True):
        close(g, w)
    ref_block = jax.jit(functools.partial(RM.mamba_block, cfg=rcfg,
                                          return_state=True))
    out, (conv, h) = TM.mamba_block(mixer, t(x), cfg)
    want, (wconv, wh) = ref_block(blk["mixer"], jnp.asarray(x))
    close(out, want)
    close(conv, wconv)
    close(h, wh)
    # a prompt shorter than the conv window pads it
    _, (conv2, _) = TM.mamba_block(mixer, t(x[:, :2]), cfg)
    _, (wconv2, _) = ref_block(blk["mixer"], jnp.asarray(x[:, :2]))
    close(conv2, wconv2)
    got = TM.mamba_decode(mixer, t(x[:, :1]), cfg, conv, h)
    want = jax.jit(functools.partial(RM.mamba_decode, cfg=rcfg))(
        blk["mixer"], jnp.asarray(x[:, :1]), conv_state=wconv,
        ssm_state=wh)
    for g, w in zip(got, want, strict=True):
        close(g, w)


# -- whole models against the reference ----------------------------------------

def forward_args(cfg):
    return (enc_input(cfg),) if cfg.encoder_layers else ()


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    ref, params, port = pair(arch)
    cfg = port.cfg
    toks = tokens(cfg.vocab_size, (2, 9))
    extra = forward_args(cfg)
    want, want_aux = ref.forward(params, jnp.asarray(toks),
                                 *map(jnp.asarray, extra))
    got, aux = port(t(toks), *map(t, extra))
    assert got.shape == (2, 9, cfg.vocab_size)
    close(got, want)
    close(aux, want_aux)
    if cfg.encoder_layers:
        close(port.encode(t(extra[0])),
              ref.encode(params, jnp.asarray(extra[0])))


def ref_cache_layer(cache, cfg, i, name):
    plen = len(cfg.block_pattern)
    return cache["stack"][f"pos{i % plen}"][name][i // plen]


def assert_cache_matches(port, cache, rcache):
    """Each layer's decode state in the port's per-kind stacks against
    the reference's per-position stacks."""
    cfg = port.cfg
    for i, layer in enumerate(port.stack.layers):
        names = layer.mixer.STATE + (("shift_c",) if layer.kind == "rwkv"
                                     else ())
        for name in names:
            close(cache[name][layer.slot],
                  ref_cache_layer(rcache, cfg, i, name))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch):
    """prefill's last logits and cache, then 3 decode steps' logits and
    the cache they leave."""
    ref, params, port = pair(arch)
    cfg = port.cfg
    b, s_prompt, steps, max_seq = 2, 6, 3, 12
    toks = tokens(cfg.vocab_size, (b, s_prompt + steps), seed=2)
    enc = enc_input(cfg) if cfg.encoder_layers else None
    want, rcache = jax.jit(functools.partial(ref.prefill, max_seq=max_seq))(
        params, jnp.asarray(toks[:, :s_prompt]),
        None if enc is None else jnp.asarray(enc))
    got, cache = port.prefill(t(toks[:, :s_prompt]),
                              None if enc is None else t(enc),
                              max_seq=max_seq)
    close(got, want)
    assert_cache_matches(port, cache, rcache)
    enc_out = ref_enc = None
    if enc is not None:
        enc_out, ref_enc = port.encode(t(enc)), ref.encode(
            params, jnp.asarray(enc))
    decode = jax.jit(ref.decode_step)
    for pos in range(s_prompt, s_prompt + steps):
        tok = toks[:, pos:pos + 1]
        want, rcache = decode(params, rcache, jnp.asarray(tok),
                              jnp.int32(pos), enc_out=ref_enc)
        got, cache = port.decode_step(cache, t(tok), pos, enc_out=enc_out)
        close(got, want)
    assert_cache_matches(port, cache, rcache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """Decoding token by token from an empty cache reproduces the full
    forward pass (teacher forcing), for every cache kind."""
    model = build_model(reduced_for_smoke(all_archs()[arch]), device="cpu")
    cfg = model.cfg
    b, s = 2, 8
    toks = t(tokens(cfg.vocab_size, (b, s), seed=6))
    enc = t(enc_input(cfg)) if cfg.encoder_layers else None
    full, _ = model(toks, enc)
    enc_out = model.encode(enc) if enc is not None else None
    cache = model.init_cache(b, s)
    steps = [model.decode_step(cache, toks[:, i:i + 1], i,
                               enc_out=enc_out)[0][:, 0]
             for i in range(s)]
    close(torch.stack(steps, dim=1), full.detach().numpy(), rtol=STEP_TOL,
          atol=STEP_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_then_decode_matches_forward(arch):
    model = build_model(reduced_for_smoke(all_archs()[arch]), device="cpu")
    cfg = model.cfg
    b, s_prompt, s_total = 2, 5, 9
    toks = t(tokens(cfg.vocab_size, (b, s_total), seed=7))
    enc = t(enc_input(cfg)) if cfg.encoder_layers else None
    full = model(toks, enc)[0].detach()
    last, cache = model.prefill(toks[:, :s_prompt], enc, max_seq=s_total)
    close(last[:, 0], full[:, s_prompt - 1].numpy(), rtol=STEP_TOL,
          atol=STEP_TOL)
    enc_out = model.encode(enc) if enc is not None else None
    for i in range(s_prompt, s_total):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i,
                                      enc_out=enc_out)
        close(lg[:, 0], full[:, i].numpy(), rtol=STEP_TOL, atol=STEP_TOL)


# -- loss and gradients against jax.grad -----------------------------------------

def assert_loss_and_grads_match(ref, params, port, batch):
    """The port's loss, its parts and every gradient leaf (within
    GRAD_RTOL of the leaf's largest absolute value) against
    ``jax.value_and_grad(ModelDef.loss)`` on the same batch."""
    from repro_torch.launch.steps import make_grad_step
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wparts), wgrads = jax.jit(jax.value_and_grad(
        lambda p: ref.loss(p, jbatch), has_aux=True))(params)
    grads, parts = make_grad_step(port)(dict(port.named_parameters()),
                                        {k: t(v) for k, v in batch.items()})
    close(parts["loss"], want)
    close(parts["nll"], wparts["nll"])
    close(parts["moe_aux"], wparts["moe_aux"])
    got = params_to_numpy(port, grads)
    flat = jax.tree_util.tree_flatten_with_path(wgrads)[0]
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat:
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max() + 1e-12, \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("variant", ["whole", "chunked_masked"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(monkeypatch, arch, variant):
    """The whole sequence without a mask, and CE_CHUNK patched to 4 on
    both sides (2 chunks of the 8 positions) under a random loss mask."""
    ref, params, port = pair(arch)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, port.cfg.vocab_size, (2, 9)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if variant == "chunked_masked":
        batch["loss_mask"] = (rng.random((2, 8)) < 0.6).astype(np.float32)
        ref = dataclasses.replace(ref)
        ref.CE_CHUNK = 4
        monkeypatch.setattr(Model, "CE_CHUNK", 4)
    if port.cfg.encoder_layers:
        batch["enc_input"] = enc_input(port.cfg)
    assert_loss_and_grads_match(ref, params, port, batch)


# -- one train step (tests/test_models_smoke.py) -------------------------------------

@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_one_train_step(arch):
    """Every registered config at reduced_for_smoke: one AdamW step
    gives a finite loss, plausible for a random init, and finite
    parameters that moved."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train.optimizer import AdamW, constant_lr
    model = build_model(reduced_for_smoke(all_archs()[arch]), device="cpu")
    cfg = model.cfg
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    batch = {"tokens": t(toks[:, :-1]), "targets": t(toks[:, 1:])}
    if cfg.encoder_layers:
        batch["enc_input"] = t(enc_input(cfg))
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    opt = AdamW(learning_rate=constant_lr(1e-3))
    params, state, metrics = make_train_step(model, opt)(
        params, opt.init(params), batch)
    loss = float(metrics["loss"])
    assert 0.0 < loss < 3.0 * np.log(cfg.vocab_size)
    assert int(state.step) == 1
    assert all(bool(torch.isfinite(p).all()) for p in params.values())
    assert not torch.equal(params["embed.tok"], before["embed.tok"])


# -- the engine and the CLI ------------------------------------------------------

def test_rwkv_engine_matches_reference_and_stepwise_forward():
    """tests/test_serving.py's rwkv6-7b case on the port, and the same
    tokens as the reference's engine."""
    ref, params, port = pair("rwkv6-7b")
    prompt = np.random.default_rng(0).integers(
        1, port.cfg.vocab_size, size=6).astype(np.int32)
    res = ServingEngine(port, max_batch=1, max_seq=24) \
        .generate([prompt], max_new_tokens=5)[0]
    want = RefEngine(ref, params, max_batch=1, max_seq=24) \
        .generate([prompt], max_new_tokens=5)[0]
    np.testing.assert_array_equal(res.tokens, want.tokens)
    seq = list(prompt)
    with torch.inference_mode():
        for _ in range(5):
            logits, _ = port(torch.tensor([seq]))
            seq.append(int(torch.argmax(logits[0, -1])))
    np.testing.assert_array_equal(res.tokens, np.asarray(seq[6:]))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_serve_cli_serves_the_recurrent_families(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--batch", "2",
                "--new-tokens", "4", "--max-seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}-smoke: batch=2" in out
    assert out.count("generated=") == 2


def test_serve_cli_refuses_encoder_decoder():
    with pytest.raises(SystemExit, match="enc-dec"):
        serve.main(["--arch", "seamless-m4t-medium", "--smoke",
                    "--device", "cpu"])
    model = build_model(reduced_for_smoke(all_archs()["seamless-m4t-medium"]),
                        device="cpu")
    with pytest.raises(ValueError, match="enc_input"):
        ServingEngine(model, max_batch=1, max_seq=8).generate(
            [np.array([1, 2], np.int32)], max_new_tokens=2)


# -- init, converter ------------------------------------------------------------

def test_random_init_has_the_reference_distributions():
    """The recurrent blocks' special leaves: RWKV lerps 0.5, decay bias
    -0.6, bonus std 0.3; Mamba's a_log = log(1..N), dt_bias -4.6, conv
    std 0.2, skip ones."""
    rwkv = build_model(reduced_for_smoke(all_archs()["rwkv6-7b"]),
                       device="cpu").stack.layers[0]
    assert torch.equal(rwkv.mixer.mu, torch.full_like(rwkv.mixer.mu, 0.5))
    assert torch.equal(rwkv.ffn.mu, torch.full_like(rwkv.ffn.mu, 0.5))
    assert torch.equal(rwkv.mixer.w0, torch.full_like(rwkv.mixer.w0, -0.6))
    assert torch.equal(rwkv.mixer.ln_scale, torch.ones_like(rwkv.mixer.w0))
    assert 0.2 < rwkv.mixer.u.std().item() < 0.4
    cfg = reduced_for_smoke(all_archs()["jamba-1.5-large-398b"])
    mamba = build_model(cfg, device="cpu").stack.layers[0].mixer
    n = cfg.ssm_state_dim
    assert torch.allclose(mamba.a_log[3], torch.log(torch.arange(1., n + 1)))
    assert torch.equal(mamba.dt_bias, torch.full_like(mamba.dt_bias, -4.6))
    assert torch.equal(mamba.d_skip, torch.ones_like(mamba.d_skip))
    assert torch.equal(mamba.conv_b, torch.zeros_like(mamba.conv_b))
    assert 0.15 < mamba.conv_w.std().item() < 0.25


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    _, _, port = pair(arch)
    tree = _PAIRS[arch][2]
    back = params_to_numpy(port)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree.leaves(back))
    for path, leaf in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf)
