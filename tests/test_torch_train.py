"""The port's training path against the JAX package's: the loss and every
gradient leaf of all ten configs, remat, AdamW and the schedules, the
train step with and without gradient accumulation, checkpoints, the
trainer's failure recovery, int8 gradient compression, the brTPF data
pipeline and the train CLI.

The reference's parameters come from ``model.init(jax.random.PRNGKey(0))``
at ``reduced_for_smoke`` and go through ``params_from_numpy`` onto the
CPU; gradients come back through ``params_to_numpy``. Inputs come from
``np.random.default_rng(seed)``. Both sides compute in float32: losses
within ``ATOL``/``RTOL``, each gradient leaf within ``GRAD_RTOL`` of its
largest absolute value, AdamW on identical gradients within ``OPT_TOL``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import distributed as dist

from repro.compat import shard_map
from repro.configs import all_archs as ref_archs
from repro.configs import reduced_for_smoke as ref_reduced
from repro.data import pipeline as RP
from repro.launch import steps as RS
from repro.models import mamba as RM
from repro.models.model import build_model as ref_build_model
from repro.train import checkpoint as RC
from repro.train import grad_compress as RG
from repro.train import optimizer as RO

from repro_torch.configs import all_archs, reduced_for_smoke
from repro_torch.data import pipeline as TP
from repro_torch.launch import steps as TS
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import Model, build_model
from repro_torch.train import checkpoint as TC
from repro_torch.train import grad_compress as TG
from repro_torch.train import optimizer as TO
from repro_torch.train.loop import Trainer, TrainerConfig

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]

# float32 on both sides, same weights and inputs
ATOL = RTOL = 1e-5
GRAD_RTOL = 1e-4
OPT_TOL = 1e-6
# Adam's first step is lr * g / (|g| + eps): where the two gradients of an
# element agree to DECIDED (relative) the updates agree to OPT_TOL; an
# element whose gradient is a near-cancelling sum at float32 noise may
# move either way, by up to 2 lr.
DECIDED = 1e-3

ARCHS = sorted(all_archs())
# the RWKV, Mamba-hybrid and encoder-decoder configs' loss and gradients
# are held to the reference in test_torch_lm_families.py
FAMILIES = ("rwkv6-7b", "jamba-1.5-large-398b", "seamless-m4t-medium")
PORTED = [a for a in ARCHS if a not in FAMILIES]

_PAIRS = {}


@pytest.fixture(autouse=True)
def _scan_unroll_one(monkeypatch):
    """The reference's selective scan unrolls 16 steps per iteration,
    which only lays out the loop and multiplies its compile time here;
    its values are the same at 1."""
    monkeypatch.setattr(RM, "SCAN_UNROLL", 1)


def pair(arch, **changes):
    """The reference model, its parameters, and the port's model on the
    CPU holding the same parameters."""
    key = (arch, tuple(sorted(changes.items())))
    if key not in _PAIRS:
        ref = ref_build_model(dataclasses.replace(
            ref_reduced(ref_archs()[arch]), **changes))
        params = jax.jit(lambda k: ref.init(k)[0])(jax.random.PRNGKey(0))
        _PAIRS[key] = (ref, params, jax.tree.map(np.asarray, params))
    ref, params, tree = _PAIRS[key]
    cfg = dataclasses.replace(reduced_for_smoke(all_archs()[arch]),
                              **changes)
    return ref, params, params_from_numpy(cfg, tree, device="cpu")


def t(x):
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype.kind in "iu"
                           else x)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def lm_batch(cfg, b=2, s=8, seed=11, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if masked:
        batch["loss_mask"] = (rng.random((b, s)) < 0.6).astype(np.float32)
    if cfg.encoder_layers:
        batch["enc_input"] = rng.normal(size=(b, 5, cfg.d_model)) \
            .astype(np.float32)
    return batch


def leaves_with_keys(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield tuple(k.key for k in path), np.asarray(leaf)


def lookup(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def ref_grad_fn(ref):
    """``jax.value_and_grad(ref.loss)`` jitted over (params, batch): one
    compile per batch shape."""
    return jax.jit(jax.value_and_grad(ref.loss, has_aux=True))


def ref_grads(ref, params, batch, fn=None):
    fn = fn or ref_grad_fn(ref)
    return fn(params, {k: jnp.asarray(v) for k, v in batch.items()})


def assert_grads_close(got_tree, want_tree):
    n = 0
    for keys, want in leaves_with_keys(want_tree):
        got = lookup(got_tree, keys)
        err = np.abs(got - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max() + 1e-12, keys
        n += 1
    assert n == len(jax.tree.leaves(got_tree))


# -- loss and gradients against jax.grad ---------------------------------------------

@pytest.mark.parametrize("variant", ["whole", "chunked_masked"])
@pytest.mark.parametrize("arch", PORTED)
def test_loss_and_grads_match_reference(monkeypatch, arch, variant):
    """``Model.loss``, its parts and every gradient leaf against
    ``jax.value_and_grad(ModelDef.loss)``: the whole sequence without a
    mask, and CE_CHUNK patched to 4 on both sides (2 chunks of the 8
    positions) under a random loss mask."""
    ref, params, port = pair(arch)
    if variant == "chunked_masked":
        ref = dataclasses.replace(ref)
        ref.CE_CHUNK = 4
        monkeypatch.setattr(Model, "CE_CHUNK", 4)
    batch = lm_batch(port.cfg, masked=variant == "chunked_masked")
    (want, wparts), wgrads = ref_grads(ref, params, batch)
    grads, parts = TS.make_grad_step(port)(dict(port.named_parameters()),
                                           {k: t(v) for k, v in
                                            batch.items()})
    close(parts["loss"], want)
    close(parts["nll"], wparts["nll"])
    close(parts["moe_aux"], wparts["moe_aux"])
    assert_grads_close(params_to_numpy(port, grads), wgrads)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "olmoe-1b-7b"])
def test_loss_and_grads_match_reference_gather_dispatch(arch):
    ref, params, port = pair(arch, moe_dispatch="gather")
    batch = lm_batch(port.cfg)
    (want, _), wgrads = ref_grads(ref, params, batch)
    grads, parts = TS.make_grad_step(port)(dict(port.named_parameters()),
                                           {k: t(v) for k, v in
                                            batch.items()})
    close(parts["loss"], want)
    assert_grads_close(params_to_numpy(port, grads), wgrads)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_gradients_with_drops_match_reference(dispatch):
    """At capacity factor 1.25 tokens drop (asserted through the outputs'
    equality, as the forward test asserts it): the gradients of a
    weighted sum of the outputs with respect to the input and every
    expert weight route as jax.grad routes them."""
    from repro.models import moe as RMOE
    from repro_torch.models import moe as TMOE
    ref, params, _ = pair("granite-moe-1b-a400m")
    moe_spec = dataclasses.replace(ref.cfg.moe, capacity_factor=1.25)
    rcfg = dataclasses.replace(ref.cfg, moe_dispatch=dispatch, moe=moe_spec)
    tcfg = dataclasses.replace(reduced_for_smoke(
        all_archs()["granite-moe-1b-a400m"]), moe_dispatch=dispatch,
        moe=moe_spec)
    blk = jax.tree.map(lambda p: np.asarray(p[0]),
                       params["stack"]["pos0"]["ffn"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    logits = x.reshape(64, -1) @ blk["router"]
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :2]
    assert np.bincount(top.ravel(), minlength=4).max() > 40  # drops

    def ref_fn(p, x):
        out, aux = RMOE.moe_ffn_with_aux(p, x, rcfg)
        return jnp.sum(out * w) + aux

    want, (wp, wx) = jax.jit(jax.value_and_grad(ref_fn, argnums=(0, 1)))(
        blk, jnp.asarray(x))
    moe = TMOE.MoE(tcfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, p in moe.named_parameters():
            p.copy_(torch.from_numpy(np.array(blk[name])))
    moe.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe(xt)
    got = (out * torch.from_numpy(w)).sum() + aux
    got.backward()
    close(got, want, rtol=1e-5, atol=1e-4)
    close(xt.grad, wx)
    for name, p in moe.named_parameters():
        err = np.abs(p.grad.numpy() - np.asarray(wp[name])).max()
        assert err <= GRAD_RTOL * np.abs(np.asarray(wp[name])).max(), name


# -- remat -------------------------------------------------------------------------

@pytest.mark.parametrize("arch,policy", [
    ("qwen2-1.5b", "full"), ("qwen2-1.5b", "dots"),
    ("granite-moe-1b-a400m", "full"), ("granite-moe-1b-a400m", "dots"),
    ("rwkv6-7b", "full"), ("jamba-1.5-large-398b", "full"),
    ("seamless-m4t-medium", "full")])
def test_remat_changes_memory_not_values(arch, policy):
    """The same loss and gradients under ``remat`` "full"/"dots" as
    under "none" (the same seeded parameters); with remat each block
    runs again in the backward pass, without it once (counted as it
    starts: the recomputation stops once the saved tensors are back)."""
    base = reduced_for_smoke(all_archs()[arch])
    batch = {k: t(v) for k, v in lm_batch(base).items()}
    results, calls = {}, {}
    for remat in ("none", policy):
        model = build_model(dataclasses.replace(base, remat=remat),
                            device="cpu")
        calls[remat] = 0

        def count(*_, remat=remat):
            calls[remat] += 1

        model.stack.layers[0].register_forward_pre_hook(count)
        results[remat] = TS.make_grad_step(model)(
            dict(model.named_parameters()), batch)
    (g0, m0), (g1, m1) = results["none"], results[policy]
    assert torch.equal(m0["loss"], m1["loss"])
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-7)
    assert (calls["none"], calls[policy]) == (1, 2)


# -- AdamW and the schedules --------------------------------------------------------

def opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "c": rng.normal(size=(2, 2, 2)).astype(np.float32)}


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_matches_reference_on_identical_gradients(clip_norm):
    """Three steps of AdamW (decay 0.1, warmup-cosine) with the same
    gradients on both sides, large enough that clipping acts: updates,
    moments, step, pre-clip norm and learning rate within OPT_TOL."""
    kw = dict(weight_decay=0.1, clip_norm=clip_norm)
    ropt = RO.AdamW(learning_rate=RO.warmup_cosine(1e-2, 2, 10), **kw)
    topt = TO.AdamW(learning_rate=TO.warmup_cosine(1e-2, 2, 10), **kw)
    rparams = {k: jnp.asarray(v) for k, v in opt_tree(0).items()}
    tparams = {k: torch.from_numpy(v) for k, v in opt_tree(0).items()}
    rstate, tstate = ropt.init(rparams), topt.init(tparams)
    for i in range(3):
        grads = {k: v * 3.0 for k, v in opt_tree(10 + i).items()}
        rup, rstate, rm = ropt.update({k: jnp.asarray(v) for k, v in
                                       grads.items()}, rstate, rparams)
        tup, tstate, tm = topt.update({k: torch.from_numpy(v) for k, v in
                                       grads.items()}, tstate, tparams)
        if clip_norm is not None:
            assert float(rm["grad_norm"]) > clip_norm
        close(tm["grad_norm"], rm["grad_norm"], rtol=OPT_TOL, atol=OPT_TOL)
        close(tm["lr"], rm["lr"], rtol=OPT_TOL, atol=0)
        for k in grads:
            close(tup[k], rup[k], rtol=OPT_TOL, atol=OPT_TOL)
            close(tstate.mu[k], rstate.mu[k], rtol=OPT_TOL, atol=OPT_TOL)
            close(tstate.nu[k], rstate.nu[k], rtol=OPT_TOL, atol=OPT_TOL)
        assert int(tstate.step) == int(rstate.step) == i + 1
        assert tstate.step.dtype == torch.int32
        rparams = RO.apply_updates(rparams, rup)
        tparams = TO.apply_updates(tparams, tup)
        for k in grads:
            close(tparams[k], rparams[k], rtol=OPT_TOL, atol=OPT_TOL)


def test_adamw_converges_on_quadratic():
    opt = TO.AdamW(learning_rate=TO.constant_lr(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(200):
        updates, state, _ = opt.update({"w": 2 * params["w"]}, state,
                                       params)
        params = TO.apply_updates(params, updates)
    assert float(params["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("peak,warm,total", [(1.0, 10, 100),
                                             (3e-4, 10, 12), (0.5, 0, 5)])
def test_warmup_cosine_matches_reference(peak, warm, total):
    rs, ts = RO.warmup_cosine(peak, warm, total), TO.warmup_cosine(
        peak, warm, total)
    for step in range(total + 3):
        close(ts(torch.tensor(step, dtype=torch.int32)),
              rs(jnp.int32(step)), rtol=OPT_TOL, atol=0)
    assert float(TO.constant_lr(0.3)(torch.tensor(4))) == pytest.approx(0.3)


def test_global_norm_matches_reference():
    tree = opt_tree(3)
    close(TO.global_norm({k: torch.from_numpy(v) for k, v in tree.items()}),
          RO.global_norm(tree), rtol=OPT_TOL, atol=0)


# -- the train step --------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 4])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m"])
def test_train_step_matches_reference(arch, grad_accum):
    """One train step from the same parameters on both sides: metrics
    within ATOL/RTOL; each parameter within OPT_TOL where the two
    gradients agree to DECIDED, within 2 lr elsewhere."""
    ref, params, port = pair(arch)
    opt_kw = dict(weight_decay=0.1)
    batch = lm_batch(port.cfg, b=4)
    ropt = RO.AdamW(learning_rate=RO.constant_lr(1e-3), **opt_kw)
    topt = TO.AdamW(learning_rate=TO.constant_lr(1e-3), **opt_kw)
    tb = {k: t(v) for k, v in batch.items()}
    tparams = dict(port.named_parameters())
    # the gradients each step applies: the mean over its microbatches
    grads, wgrads, fn = [], [], ref_grad_fn(ref)
    for i in range(grad_accum):
        rows = slice(i * 4 // grad_accum, (i + 1) * 4 // grad_accum)
        grads.append(params_to_numpy(port, TS.make_grad_step(port)(
            tparams, {k: v[rows] for k, v in tb.items()})[0]))
        wgrads.append(ref_grads(ref, params, {k: v[rows] for k, v in
                                              batch.items()}, fn)[1])
    grads = jax.tree.map(lambda *g: sum(g) / grad_accum, *grads)
    wgrads = jax.tree.map(lambda *g: sum(np.asarray(x) for x in g)
                          / grad_accum, *wgrads)
    rnew, _, rm = RS.make_train_step(ref, ropt, grad_accum=grad_accum)(
        params, ropt.init(params), {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    tparams, tstate, tm = TS.make_train_step(port, topt,
                                             grad_accum=grad_accum)(
        tparams, topt.init(tparams), tb)
    assert int(tstate.step) == 1
    for key in ("loss", "nll", "moe_aux", "grad_norm", "lr"):
        close(tm[key], rm[key])
    new = params_to_numpy(port)
    for keys, want in leaves_with_keys(rnew):
        got, g = lookup(new, keys), lookup(grads, keys)
        wg = lookup(wgrads, keys)
        decided = np.abs(g - wg) <= DECIDED * np.abs(wg)
        diff = np.abs(got - want)
        assert (diff[decided] <= OPT_TOL).all(), keys
        assert (diff <= 2e-3 + OPT_TOL).all(), keys


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "chatglm3-6b"])
def test_grad_accum_matches_full_batch(arch):
    """grad_accum=4 == grad_accum=1 on the same batch, at the reference
    test's tolerances (tests/test_loss_and_cli.py). Dense configs, as
    there: an MoE's load-balancing loss is a product of means over the
    tokens of a microbatch, so it changes with the microbatching."""
    model = build_model(reduced_for_smoke(all_archs()[arch]), device="cpu")
    opt = TO.AdamW(learning_rate=TO.constant_lr(1e-2), weight_decay=0.0)
    batch = {k: t(v) for k, v in lm_batch(model.cfg, b=4).items()}
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    out = {}
    for k in (1, 4):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])
        _, _, m = TS.make_train_step(model, opt, grad_accum=k)(
            params, opt.init(params), batch)
        out[k] = (float(m["loss"]),
                  {n: p.detach().clone() for n, p in params.items()})
    assert out[4][0] == pytest.approx(out[1][0], rel=1e-5)
    for n in params:
        close(out[4][1][n], out[1][1][n].numpy(), rtol=2e-3, atol=2e-5)


def test_train_step_refuses_other_params():
    model = build_model(reduced_for_smoke(all_archs()["qwen2-1.5b"]),
                        device="cpu")
    opt = TO.AdamW(learning_rate=TO.constant_lr(1e-3))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: t(v) for k, v in lm_batch(model.cfg).items()}
    with pytest.raises(ValueError, match="named_parameters"):
        TS.make_train_step(model, opt)(params, opt.init(params), batch)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "seamless-m4t-medium"])
def test_prefill_and_serve_steps_match_reference(arch):
    ref, params, port = pair(arch)
    cfg = port.cfg
    batch = lm_batch(cfg, s=6)
    toks = batch["tokens"]
    extra = (batch["enc_input"],) if cfg.encoder_layers else ()
    want, rcache = RS.make_prefill_step(ref, max_seq=8)(
        params, jnp.asarray(toks), *map(jnp.asarray, extra))
    got, cache = TS.make_prefill_step(port, max_seq=8)(t(toks),
                                                       *map(t, extra))
    close(got, want)
    dec_extra, ref_extra = (), ()
    if cfg.encoder_layers:
        dec_extra = (port.encode(t(extra[0])),)
        ref_extra = (ref.encode(params, jnp.asarray(extra[0])),)
    tok = toks[:, -1:]
    want, _ = RS.make_serve_step(ref)(params, rcache, jnp.asarray(tok),
                                      jnp.int32(6), *ref_extra)
    got, _ = TS.make_serve_step(port)(cache, t(tok), 6, *dec_extra)
    close(got, want)


@pytest.mark.parametrize("arch", PORTED)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    _, _, port = pair(arch)
    tree = _PAIRS[(arch, ())][2]
    back = params_to_numpy(port)
    for keys, leaf in leaves_with_keys(tree):
        np.testing.assert_array_equal(lookup(back, keys), leaf)
    assert len(jax.tree.leaves(back)) == len(jax.tree.leaves(tree))


# -- checkpoints ------------------------------------------------------------------------

def state_tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"a": torch.randn(8, 4, generator=gen),
              "nested.b": torch.arange(6, dtype=torch.int32)}
    return {"params": params,
            "opt_state": TO.AdamW(TO.constant_lr(1e-3)).init(params)}


def assert_trees_equal(got, want):
    from repro_torch.train import tree as T
    for (pg, g), (pw, w) in zip(T.leaves_with_path(got),
                                T.leaves_with_path(want), strict=True):
        assert pg == pw and torch.equal(g, w), pg


class TestCheckpoint:
    def test_roundtrip_and_layout(self, tmp_path):
        tree = state_tree()
        path = TC.save(str(tmp_path), 7, tree)
        assert os.path.basename(path) == "step_00000007"
        assert sorted(os.listdir(path)) == (
            [TC.COMMIT_FILE] + [f"leaf_{i:05d}.npy" for i in range(7)]
            + ["manifest.json"])
        manifest = json.loads(Path(path, "manifest.json").read_text())
        assert manifest["step"] == 7
        assert [m["path"] for m in manifest["leaves"]] == [
            "['params']['a']", "['params']['nested.b']",
            "['opt_state'].step", "['opt_state'].mu['a']",
            "['opt_state'].mu['nested.b']", "['opt_state'].nu['a']",
            "['opt_state'].nu['nested.b']"]
        assert manifest["leaves"][0] == {
            "path": "['params']['a']", "file": "leaf_00000.npy",
            "shape": [8, 4], "dtype": "float32", "nbytes": 128}
        step, restored = TC.restore(str(tmp_path), tree)
        assert step == 7
        assert_trees_equal(restored, tree)
        assert isinstance(restored["opt_state"], TO.AdamWState)

    def test_reference_reads_the_ports_checkpoint_and_back(self, tmp_path):
        """The same layout and manifest: each package restores the
        other's checkpoint of a tree of dicts."""
        tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
                "b": {"c": np.ones(5, np.int32)}}
        TC.save(str(tmp_path / "port"), 3, tree)
        RC.save(str(tmp_path / "ref"), 3, tree)
        mine = json.loads((tmp_path / "port" / "step_00000003" /
                           "manifest.json").read_text())
        theirs = json.loads((tmp_path / "ref" / "step_00000003" /
                             "manifest.json").read_text())
        assert mine == theirs
        _, back = RC.restore(str(tmp_path / "port"), tree)
        np.testing.assert_array_equal(np.asarray(back["a"]), tree["a"])
        _, back = TC.restore(str(tmp_path / "ref"), tree)
        np.testing.assert_array_equal(back["b"]["c"].numpy(),
                                      tree["b"]["c"])

    def test_partial_write_ignored(self, tmp_path):
        tree = state_tree()
        TC.save(str(tmp_path), 1, tree)
        bad = tmp_path / "step_00000002"      # crashed before COMMIT
        bad.mkdir()
        (bad / "manifest.json").write_text("{}")
        (tmp_path / "step_00000003.tmp").mkdir()
        assert TC.latest_step(str(tmp_path)) == 1
        assert TC.restore(str(tmp_path), tree)[0] == 1

    def test_truncated_leaf_falls_back(self, tmp_path):
        tree = state_tree()
        TC.save(str(tmp_path), 1, tree)
        TC.save(str(tmp_path), 2, state_tree(seed=1))
        leaf = tmp_path / "step_00000002" / "leaf_00000.npy"
        leaf.write_bytes(leaf.read_bytes()[:16])
        step, restored = TC.restore(str(tmp_path), tree)
        assert step == 1
        assert_trees_equal(restored, tree)
        with pytest.raises(FileNotFoundError):
            TC.restore(str(tmp_path / "none"), tree)

    def test_cleanup_keeps_n(self, tmp_path):
        for s in range(5):
            TC.save(str(tmp_path), s, state_tree())
        TC.cleanup(str(tmp_path), keep=2)
        assert TC.valid_steps(str(tmp_path)) == [3, 4]

    def test_async_snapshot_and_wait(self, tmp_path):
        """The saved values are those at ``save``, not those after a
        later in-place update; ``wait`` joins, and re-raises a failed
        write."""
        tree = state_tree()
        want = {"params": {k: v.clone() for k, v in
                           tree["params"].items()},
                "opt_state": tree["opt_state"]}
        saver = TC.AsyncCheckpointer(str(tmp_path), keep=2)
        saver.save(3, tree)
        tree["params"]["a"].add_(1.0)
        saver.wait()
        assert saver.saved_steps == [3]
        _, restored = TC.restore(str(tmp_path), tree)
        assert_trees_equal(restored, want)
        blocked = TC.AsyncCheckpointer(str(tmp_path / "file"))
        (tmp_path / "file").write_text("not a directory")
        blocked.save(1, tree)
        with pytest.raises(OSError):
            blocked.wait()
        blocked.wait()   # the error is raised once

    def test_restore_onto_cpu(self, tmp_path):
        tree = state_tree()
        TC.save(str(tmp_path), 4, tree)
        step, restored = TC.restore(str(tmp_path), tree, device="cpu",
                                    step=4)
        assert step == 4
        assert all(x.device.type == "cpu"
                   for x in restored["params"].values())
        with pytest.raises(FileNotFoundError):
            TC.restore(str(tmp_path), tree, step=5)


# -- the trainer ----------------------------------------------------------------------

def toy(tmp_path, total=30, ckpt_every=5, **kw):
    opt = TO.AdamW(learning_rate=TO.constant_lr(0.05), weight_decay=0.0)
    params = {"w": torch.tensor(4.0)}

    def step_fn(params, opt_state, batch):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.square(w - batch["target"]).sum()
        loss.backward()
        updates, opt_state, _ = opt.update({"w": w.grad}, opt_state, params)
        return (TO.apply_updates(params, updates), opt_state,
                {"loss": loss.detach()})

    cfg = TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path),
                        ckpt_every=ckpt_every, max_restarts=3, **kw)
    return cfg, step_fn, params, opt.init(params)


def toy_data():
    while True:
        yield {"target": torch.tensor(1.0)}


class TestTrainer:
    def test_runs_and_learns(self, tmp_path):
        tr = Trainer(*toy(tmp_path))
        report = tr.train(toy_data())
        assert report.steps_run == 30
        assert report.final_loss < report.losses[0]
        assert TC.latest_step(str(tmp_path)) == 30

    def test_restart_replays_to_the_uninterrupted_run(self, tmp_path):
        """A failure before step 5 restores the step-4 checkpoint and
        replays steps 4 and 5 on their own batches: the losses of every
        step equal an uninterrupted run's, and the parameters at the end
        are the same."""
        cfg = reduced_for_smoke(all_archs()["qwen2-1.5b"])
        corpus = TP.SyntheticCorpus.generate(num_docs=60,
                                             vocab_size=cfg.vocab_size)
        pipe = TP.BrTPFDataPipeline(corpus, "?d hasDomain code",
                                    batch_size=2, seq_len=16)
        it = iter(pipe)
        batches = [{k: t(v) for k, v in next(it).items()} for _ in range(8)]

        def run(ckpt_dir, hook):
            model = build_model(cfg, device="cpu")
            params = dict(model.named_parameters())
            opt = TO.AdamW(learning_rate=TO.warmup_cosine(1e-2, 2, 8))
            tr = Trainer(TrainerConfig(total_steps=8, ckpt_dir=ckpt_dir,
                                       ckpt_every=2),
                         TS.make_train_step(model, opt), params,
                         opt.init(params), failure_hook=hook)
            report = tr.train(batches[tr.step] for _ in iter(int, 1))
            return tr, report, params

        fired = []

        def hook(step):
            if step == 5 and not fired:
                fired.append(step)
                raise RuntimeError("simulated node failure")

        plain, want, pparams = run(str(tmp_path / "a"), None)
        tr, report, params = run(str(tmp_path / "b"), hook)
        assert report.restarts == 1 and tr.step == 8
        assert report.steps_run == 9          # 5 before, 4..7 after
        assert report.losses == want.losses[:5] + want.losses[4:]
        for n, p in params.items():
            assert torch.equal(p, pparams[n]), n
        # the restore wrote into the model's own parameters
        assert params["embed.tok"] is tr.params["embed.tok"]

    def test_too_many_failures_raises(self, tmp_path):
        def always_fail(step):
            raise RuntimeError("dead node")

        tr = Trainer(*toy(tmp_path), failure_hook=always_fail)
        with pytest.raises(RuntimeError, match="dead node"):
            tr.train(toy_data())

    def test_resume_across_trainer_instances(self, tmp_path):
        Trainer(*toy(tmp_path, total=10)).train(toy_data())
        tr2 = Trainer(*toy(tmp_path, total=20))
        assert tr2.try_resume()
        assert tr2.step == 10
        report = tr2.train(toy_data())
        assert tr2.step == 20 and report.steps_run == 10

    def test_injected_slow_step_is_a_straggler(self, tmp_path):
        import time
        cfg, step_fn, params, state = toy(tmp_path, total=16,
                                          ckpt_every=100)

        def slow_at_12(params, opt_state, batch):
            time.sleep(0.25 if int(opt_state.step) == 12 else 0.005)
            return step_fn(params, opt_state, batch)

        seen = []
        tr = Trainer(cfg, slow_at_12, params, state,
                     on_straggler=lambda step, dt: seen.append(step))
        report = tr.train(toy_data())
        assert 12 in seen and report.stragglers == len(seen) >= 1

    def test_restore_onto_moves_into_the_same_tensors(self, tmp_path):
        cfg, step_fn, params, state = toy(tmp_path, total=5, ckpt_every=5)
        tr = Trainer(cfg, step_fn, params, state)
        tr.train(toy_data())
        w = tr.params["w"]
        saved = float(w)
        with torch.no_grad():
            w.fill_(100.0)
        tr.restore_onto("cpu")
        assert tr.params["w"] is w and float(w) == saved and tr.step == 5


# -- gradient compression ----------------------------------------------------------------

@pytest.mark.parametrize("seed,shape,scale", [(0, (128,), 1.0),
                                              (1, (7, 9), 1e-3),
                                              (2, (3, 4, 5), 50.0)])
def test_quantize_matches_reference(seed, shape, scale):
    g = (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)
    q, s = TG.quantize(torch.from_numpy(g))
    rq, rs = RG.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    close(s, rs, rtol=0, atol=0)
    close(TG.dequantize(q, s), RG.dequantize(rq, rs), rtol=0, atol=0)
    err = (TG.dequantize(q, s) - torch.from_numpy(g)).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-6


def test_error_feedback_matches_reference_and_reduces_bias():
    rng = np.random.default_rng(1)
    seq = [(rng.normal(size=(64,)) * 0.01).astype(np.float32)
           for _ in range(50)]
    err = TG.init_error_state({"g": torch.zeros(64)})["g"]
    rerr = jnp.zeros((64,), jnp.float32)
    acc_fb, acc_nofb, acc_true = np.zeros(64), np.zeros(64), np.zeros(64)
    for g in seq:
        q, s, err = TG.compress_with_feedback(torch.from_numpy(g), err)
        rq, rs, rerr = RG.compress_with_feedback(jnp.asarray(g), rerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        close(err, rerr, rtol=0, atol=1e-9)
        acc_fb += TG.dequantize(q, s).numpy()
        acc_nofb += TG.dequantize(*TG.quantize(torch.from_numpy(g))).numpy()
        acc_true += g
    assert np.abs(acc_fb - acc_true).mean() <= \
        np.abs(acc_nofb - acc_true).mean() + 1e-9


def test_compressed_psum_tree_in_a_gloo_group(tmp_path):
    """World size 1: the reduced gradient is the dequantized int8 one and
    the error state its residual, as the reference computes them in a
    one-device shard_map."""
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(32,)).astype(np.float32),
             "b": {"c": rng.normal(size=(3, 4)).astype(np.float32)}}
    errs = {"w": rng.normal(size=(32,)).astype(np.float32) * 1e-3,
            "b": {"c": np.zeros((3, 4), np.float32)}}
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want, want_err = shard_map(
        lambda g, e: RG.compressed_psum_tree(g, e, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False)(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, errs))
    group = None
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    try:
        got, got_err = TG.compressed_psum_tree(
            {"w": torch.from_numpy(grads["w"]),
             "b": {"c": torch.from_numpy(grads["b"]["c"])}},
            {"w": torch.from_numpy(errs["w"]),
             "b": {"c": torch.from_numpy(errs["b"]["c"])}}, group)
    finally:
        dist.destroy_process_group()
    close(got["w"], want["w"], rtol=1e-6, atol=1e-7)
    close(got["b"]["c"], want["b"]["c"], rtol=1e-6, atol=1e-7)
    close(got_err["w"], want_err["w"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["w"].numpy(), grads["w"] + errs["w"],
                               atol=2e-2)


# -- the data pipeline -----------------------------------------------------------------

SELECTIONS = ["?d hasDomain code\n?d hasQuality q0",
              "?d hasLang en",
              "?d hasDomain science\n?d hasLang de\n?d type Document"]


@pytest.mark.parametrize("num_docs,vocab,seed,query,batch,seq", [
    (100, 512, 3, SELECTIONS[0], 4, 32),
    (300, 151936, 0, SELECTIONS[0], 4, 64),
    (200, 1024, 5, SELECTIONS[1], 3, 17),
    (150, 4096, 7, SELECTIONS[2], 2, 128)])
def test_pipeline_matches_reference(num_docs, vocab, seed, query, batch,
                                    seq):
    """The same corpus, selected documents, brTPF request and triple
    counts, and the first batches byte for byte."""
    mine = TP.BrTPFDataPipeline(TP.SyntheticCorpus.generate(
        num_docs=num_docs, vocab_size=vocab, seed=seed), query,
        batch_size=batch, seq_len=seq)
    theirs = RP.BrTPFDataPipeline(RP.SyntheticCorpus.generate(
        num_docs=num_docs, vocab_size=vocab, seed=seed), query,
        batch_size=batch, seq_len=seq)
    np.testing.assert_array_equal(mine.corpus.store.triples,
                                  theirs.corpus.store.triples)
    assert mine.selected_docs == theirs.selected_docs
    assert dataclasses.asdict(mine.stats) == dataclasses.asdict(
        theirs.stats)
    assert mine.stats.selected_docs > 0 and mine.stats.num_requests > 0
    for _, a, b in zip(range(5), mine.batches(), theirs.batches()):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
        np.testing.assert_array_equal(a["tokens"][:, 1:],
                                      a["targets"][:, :-1])


def test_pipeline_empty_selection_raises():
    corpus = TP.SyntheticCorpus.generate(num_docs=20, seed=4)
    corpus.dictionary.intern("nonexistent")
    with pytest.raises(ValueError, match="no documents"):
        TP.BrTPFDataPipeline(corpus, "?d hasDomain nonexistent",
                             batch_size=2, seq_len=16)


# -- the train CLI -------------------------------------------------------------------

def test_train_cli_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--smoke", "--steps", "6", "--batch", "2", "--seq",
         "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
        check=False)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[train] qwen2-1.5b-smoke: 0.1M params on cpu" in r.stdout
    assert "[data] brTPF selection: 24 docs, 4 requests" in r.stdout
    assert "[done] steps=6 restarts=0 loss " in r.stdout


def test_train_cli_resumes_from_its_checkpoint(capsys, tmp_path):
    args = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    train_cli.main(args + ["--steps", str(train_cli.CKPT_EVERY)])
    assert TC.latest_step(str(tmp_path)) == train_cli.CKPT_EVERY
    train_cli.main(args + ["--steps", str(train_cli.CKPT_EVERY + 2)])
    out = capsys.readouterr().out
    assert f"[ckpt] resumed at step {train_cli.CKPT_EVERY}" in out
    assert "[done] steps=2 restarts=0" in out
    # resumed at its last step, a run has nothing left to do
    train_cli.main(args + ["--steps", str(train_cli.CKPT_EVERY)])
    assert "[done] steps=0 restarts=0" in capsys.readouterr().out


def test_train_cli_encoder_decoder(capsys, tmp_path):
    train_cli.main(["--arch", "seamless-m4t-medium", "--smoke", "--steps",
                    "2", "--batch", "2", "--seq", "8", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])
    assert "[done] steps=2 restarts=0" in capsys.readouterr().out

