"""The port's sharding layer against the JAX package's: the logical-axis
rules, the parameters' and caches' logical axes, the per-leaf global and
local shapes of the dry-run's input specs on the (2, 2) mini mesh, the
useful-FLOPs formula, the roofline counter and the brTPF engine step's
collectives.

The reference's specs come from a subprocess with 8 host devices (its
specs build before its mini dry-run's lowering fails); the port's are
DTensor stand-ins on fake tensors over a fake process group, made and
destroyed inside each test.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import (ALL_SHAPES, all_archs as ref_archs,
                                reduced_for_smoke as ref_reduced)
from repro.launch.roofline import model_flops_for as ref_model_flops
from repro.sharding import rules as RR

from repro_torch.configs.base import get_arch, reduced_for_smoke
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MINI, fake_mesh, mesh_name
from repro_torch.launch.steps import make_grad_step, make_train_step
from repro_torch.models.axes import axes_tree, cache_axes
from repro_torch.models.convert import tree_key
from repro_torch.models.model import Model, build_model
from repro_torch.sharding import rules as TR
from repro_torch.train.optimizer import AdamW, constant_lr

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(ref_archs())

# (logical axes, rules) cases: the reference's tests/test_sharding.py
# TestSpecFor and the default rules on every leaf kind the models use.
SPEC_CASES = [
    (("batch", "embed", "ff"), {"batch": "data", "ff": "model",
                                "embed": None}),
    (("batch", None, None), {"batch": "data"}),
    (("a", "b"), {"a": "model", "b": "model"}),
    (("batch", None), {"batch": ("pod", "data")}),
    (("unknown", "ff"), {"ff": "model"}),
    ((), {"batch": "data"}),
] + [(axes, rules) for rules in (RR.default_rules(False),
                                 RR.default_rules(True),
                                 {**RR.default_rules(True),
                                  "embed": "data"})
     for axes in (("batch", "seq", "act_embed"), ("vocab", "embed"),
                  ("layers", "embed", "heads"), ("layers", "heads", "embed"),
                  ("experts", "embed", "ff_expert"),
                  ("layers", "batch", "kv_seq", "kv_heads", None),
                  ("zero", "kv_heads"), ("embed", "zero"),
                  ("batch", None, "act_embed"), ("ssm_inner", None))]


@pytest.mark.parametrize("axes,rules", SPEC_CASES)
def test_spec_for_equals_reference(axes, rules):
    assert TR.spec_for(axes, rules) == tuple(RR.spec_for(axes, rules))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_default_rules_equal_reference(multi_pod):
    assert TR.default_rules(multi_pod) == RR.default_rules(multi_pod)


def test_constrain_is_a_noop_without_rules_or_dtensor():
    x = torch.ones(4, 4)
    assert TR.constrain(x, "batch", "ff") is x
    with fake_mesh(*MINI[False], device_type="cpu") as mesh:
        with TR.use_rules(mesh, TR.default_rules()):
            assert TR.active()[0] is mesh
            assert TR.constrain(x, "batch", "ff") is x
    assert TR.active() is None


@pytest.mark.parametrize("shape,axes,want", [
    ((4, 6), ("batch", "ff"), ("data", "model")),
    ((3, 6), ("batch", "ff"), (None, "model")),     # 3 rows on 2 ranks
    ((4, 3), ("batch", "ff"), ("data",)),
    ((8, 2, 16), ("batch", "kv_heads", None), ("data", "model")),
])
def test_divisibility_guard_and_placements(shape, axes, want):
    from torch.distributed.tensor import Replicate, Shard
    with fake_mesh(*MINI[False], device_type="cpu") as mesh:
        spec = TR.guard(TR.spec_for(axes, TR.default_rules()), shape, mesh)
        assert spec == want
        pl = TR.placements_for(spec, mesh)
        for name, p in zip(mesh.mesh_dim_names, pl):
            dims = [i for i, part in enumerate(spec) if part == name]
            assert p == (Shard(dims[0]) if dims else Replicate())


def test_multi_axis_placements():
    from torch.distributed.tensor import Replicate, Shard
    with fake_mesh(*MINI[True], device_type="cpu") as mesh:
        spec = TR.spec_for(("batch", None, "ff"), TR.default_rules(True))
        assert spec == (("pod", "data"), None, "model")
        assert TR.placements_for(spec, mesh) == (Shard(0), Shard(0),
                                                 Shard(2))
        assert TR.placements_for((), mesh) == (Replicate(),) * 3


def _ref_axes(cfg, cache=False):
    import jax
    from repro.models.model import build_model
    md = build_model(cfg)
    box = {}

    def init(k):
        p, a = md.init(k)
        box["a"] = a
        return p

    def init_cache():
        c, a = md.init_cache(2, 8)
        box["a"] = a
        return c

    if cache:
        jax.eval_shape(init_cache)
    else:
        jax.eval_shape(init, jax.random.PRNGKey(0))
    return box["a"]


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_reference(arch):
    cfg = reduced_for_smoke(get_arch(arch))
    model = Model(cfg, torch.float32, torch.device("meta"))
    ref_cfg = ref_reduced(ref_archs()[arch])
    assert axes_tree(model) == _ref_axes(ref_cfg)
    ref_cache = _ref_axes(ref_cfg, cache=True)["stack"]
    got = cache_axes(cfg)
    assert set(got) == {n for pos in ref_cache.values() for n in pos}
    for pos in ref_cache.values():
        for name, axes in pos.items():
            assert got[name] == axes


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    cfg, ref_cfg = get_arch(arch), ref_archs()[arch]
    for shape in ALL_SHAPES:
        assert RL.model_flops_for(cfg, shape) == ref_model_flops(ref_cfg,
                                                                 shape)


# -- per-leaf shapes of the dry-run's specs on mini2x2 ----------------------------

_REF_SPECS = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from repro.configs.base import ALL_SHAPES, all_archs, reduced_for_smoke
from repro.launch.specs import (batch_specs, cache_specs, opt_state_specs,
                                param_specs)
from repro.models.model import build_model
from repro.sharding.rules import default_rules

def key(path):
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)

def dump(tree):
    return {key(p): [list(s.shape), list(s.sharding.shard_shape(s.shape)),
                     str(s.dtype)]
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}

shapes = {s.name: s for s in ALL_SHAPES}
out = {}
mesh = jax.make_mesh((2, 2), ("data", "model"))
for name, cfg in sorted(all_archs().items()):
    cfg = dataclasses.replace(reduced_for_smoke(cfg), name=name)
    rules = default_rules()
    rules.update(dict(cfg.sharding_overrides))
    model = build_model(cfg, dtype=jnp.bfloat16)
    rec = {}
    p, axes = param_specs(model, mesh, rules)
    rec["params"] = dump(p)
    rec["opt"] = dump(opt_state_specs(p, mesh, axes, rules))
    for sname in ("train_4k", "decode_32k"):
        shape = dataclasses.replace(shapes[sname], seq_len=256,
                                    global_batch=8)
        rec["batch_" + sname] = dump(batch_specs(cfg, shape, mesh, rules))
        rec["cache_" + sname] = dump(cache_specs(model, shape, mesh, rules))
    out[name] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_specs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_SPECS], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=False, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


def _leaf(t):
    return [list(t.shape), list(t._local_tensor.shape), _dtype(t)]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_shapes_equal_reference(arch, ref_specs):
    """Global shape, rank 0's shard shape and dtype of every leaf of
    param_specs / opt_state_specs / batch_specs / cache_specs; a leaf
    stacked over layers in the reference is the port's per-layer (or
    per-kind) tensor, the layers dimension unsharded."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import dataclasses
    from repro_torch.launch import specs as S
    ref = ref_specs[arch]
    cfg = dataclasses.replace(reduced_for_smoke(get_arch(arch)), name=arch)
    rules = TR.default_rules()
    rules.update(dict(cfg.sharding_overrides))
    shapes = {s.name: s for s in ALL_SHAPES}
    with fake_mesh(*MINI[False], device_type="cpu") as mesh, \
            FakeTensorMode():
        model = Model(cfg, torch.bfloat16, torch.device("meta"))
        p, axes = S.param_specs(model, mesh, rules)
        opt = S.opt_state_specs(p, mesh, axes, rules)
        for tree, ref_tree in ((p, ref["params"]),
                               (opt.mu, {k[3:]: v for k, v in
                                         ref["opt"].items()
                                         if k.startswith("mu/")}),
                               (opt.nu, {k[3:]: v for k, v in
                                         ref["opt"].items()
                                         if k.startswith("nu/")})):
            for name, t in tree.items():
                k, index, _ = tree_key(cfg, name)
                want = ref_tree["/".join(k)]
                if index is not None:           # drop the layers dim
                    want = [want[0][1:], want[1][1:], want[2]]
                assert _leaf(t) == want, name
            assert len({tree_key(cfg, n)[0] for n in tree}) == len(ref_tree)
        assert _leaf(opt.step) == ref["opt"]["step"]
        for sname in ("train_4k", "decode_32k"):
            shape = dataclasses.replace(shapes[sname], seq_len=256,
                                        global_batch=8)
            batch = S.batch_specs(cfg, shape, mesh, rules)
            assert {k: _leaf(v) for k, v in batch.items()} == \
                ref["batch_" + sname]
            cache = S.cache_specs(model, shape, mesh, rules)
            ref_cache = ref["cache_" + sname]
            for k, v in ref_cache.items():
                leaf = k.rsplit("/", 1)[-1]
                got = _leaf(cache[leaf])
                assert [got[0][1:], got[1][1:], got[2]] == \
                    [v[0][1:], v[1][1:], v[2]], k
                assert got[0][0] == got[1][0]    # layers unsharded


# -- the roofline counter ------------------------------------------------------------

def test_counter_matmul_flops():
    """The counterpart of the reference's while-loop test: 5 looped
    [8,16]x[16,16] matmuls are 5 * 2*8*16*16 = 20,480 FLOPs."""
    x, w = torch.ones(8, 16), torch.ones(16, 16)
    with RL.CostCounter() as c:
        for _ in range(5):
            x = x @ w
    assert c.flops == 20480.0
    assert c.bytes == 5 * (8 * 16 + 16 * 16 + 8 * 16) * 4


def test_counter_collective_bytes_and_counts():
    """One all-reduce of f32 [128, 256]: 131,072 result bytes, charged to
    the mesh dim whose group it ran on."""
    from torch.distributed import _functional_collectives as funcol
    with fake_mesh(*MINI[False], device_type="cpu") as mesh:
        c = RL.CostCounter(RL.group_names(mesh))
        with c:
            y = funcol.all_reduce(torch.ones(128, 256), "sum",
                                  mesh.get_group("model"))
            funcol.wait_tensor(y)
        assert dict(c.coll_counts) == {"all-reduce": 1}
        assert c.coll_bytes == {"model": 131072}
        r = RL.analyze("a", "s", "m", 4, c, 0.0)
        assert r.coll_bytes_per_chip == 131072
        assert r.collective_s == 131072 / RL.NVLINK_BW
    assert set(r.to_dict()) >= {
        "arch", "shape", "mesh", "chips", "flops_per_chip",
        "bytes_per_chip", "coll_bytes_per_chip", "coll_counts",
        "model_flops", "memory_per_device_gb", "compute_s", "memory_s",
        "collective_s", "dominant", "useful_flops_ratio",
        "roofline_fraction"}


def test_counter_peak_memory():
    """Live bytes of the storages made under the counter, and their
    peak: views and in-place results add nothing."""
    with RL.CostCounter() as c:
        a = torch.empty(1000)
        b = a * 2
        del b
        d = a + 1
        d.view(10, 100).add_(1)
    assert (c.peak, c.live) == (8000, 8000)
    del a, d
    assert c.live == 0


@pytest.mark.parametrize("contiguous,want", [(True, 1024), (False, 1536)])
def test_counter_charges_the_softmax_backward_scratch(contiguous, want):
    """CUDA's softmax backward holds ``grad * output`` above its 512-byte
    output while it runs, and a contiguous copy of it when the gradient
    is not contiguous: the peak counts both, whatever the device."""
    out = torch.softmax(torch.randn(8, 16), dim=-1)
    grad = torch.randn(8, 16) if contiguous else torch.randn(16, 8).t()
    with RL.CostCounter() as c:
        gi = torch.ops.aten._softmax_backward_data(grad, out, -1,
                                                   torch.float32)
    assert gi.shape == (8, 16)
    assert (c.live, c.peak) == (512, want)


def test_roofline_constants_are_the_h100s():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW, RL.IB_BW) == (
        989.4e12, 3.35e12, 450e9, 50e9)


def test_scan_cost_equals_the_loop():
    from repro_torch.models.mamba import scan_cost, selective_scan
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .to(dtype) for s in ((2, 5, 12), (2, 5, 12), (2, 5, 4),
                                     (2, 5, 4))]
        a = -torch.rand(12, 4)
        with RL.CostCounter() as c:
            selective_scan(*args, a)
        assert (c.flops, c.bytes) == scan_cost(
            (2, 5, 12), 4, args[0].element_size())


def test_extrapolation_is_bilinear():
    from repro_torch.launch.dryrun import _extrapolate

    def totals(d, m):
        v = 3.0 + 5 * d + 7 * m + 11 * d * m
        return dict(flops=v, bytes=2 * v, int_ops=0.0, arg=d, out=1.0,
                    temp=4.0 * d + m, coll_bytes={"data": v},
                    coll_counts={"all-gather": d * m}, t_build=0.0,
                    t_trace=1.0, chips=4, grad_accum=m, redistributed={},
                    top_ops="")

    pts = {(d, m): totals(d, m) for d in (8, 16) for m in (1, 2)}
    got = _extrapolate(pts, 72, 8)
    want = totals(72, 8)
    for k in ("flops", "bytes", "arg"):
        assert got[k] == pytest.approx(want[k])
    assert got["temp"] == pytest.approx(4.0 * 72 + 2)   # at 2 traced
    assert got["coll_counts"] == {"all-gather": 576}
    assert got["coll_bytes"]["data"] == pytest.approx(want["flops"])
    assert got["t_trace"] == 4.0 and got["grad_accum"] == 8


def test_sampled_trace_equals_full_trace():
    """Two traced layers extrapolate to qwen2-1.5b's 28: every total of
    its decode_32k cell on gpu32x8 as the full trace counts it."""
    from repro_torch.launch.dryrun import trace_cell
    full = trace_cell("qwen2-1.5b", "decode_32k", False, device="cpu")
    part = trace_cell("qwen2-1.5b", "decode_32k", False, device="cpu",
                      sample=True)
    assert part["traced"] == [(1, 1), (2, 1)]
    for k in ("flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
              "coll_counts"):
        assert part["roofline"][k] == pytest.approx(full["roofline"][k])
    for k in ("argument_size_gb", "output_size_gb"):
        assert part["memory_analysis"][k] == pytest.approx(
            full["memory_analysis"][k])
    assert part["memory_analysis"]["temp_size_gb"] == pytest.approx(
        full["memory_analysis"]["temp_size_gb"], rel=0.01)


# -- the engine step's collectives ---------------------------------------------------

@pytest.mark.parametrize("variant,gathers,nbytes", [
    ("baseline", 2, 786_560), ("windowed", 3, 524_480)])
def test_engine_collectives_equal_reference_16x16(variant, gathers, nbytes):
    """The reference's engine dry-run on its 16x16 pod: 2 all-gathers of
    786,560 bytes (baseline) and 3 of 524,480 (windowed)."""
    from repro_torch.launch.engine_dryrun import lower_variant
    with fake_mesh((16, 16), ("data", "model"), device_type="cpu") as mesh:
        rec = lower_variant(variant, mesh=mesh, device="cpu")
    r = rec["roofline"]
    assert r["coll_counts"] == {"all-gather": gathers}
    assert r["coll_bytes_per_chip"] == nbytes
    assert r["coll_bytes_by_dim"] == {"data": nbytes}
    assert rec["shard_n"] == (1 << 30) // 16
    assert r["int_ops_per_chip"] > 0


def test_mesh_names():
    assert [mesh_name(m, mini) for mini in (False, True)
            for m in (False, True)] == ["gpu32x8", "gpu2x32x8", "mini2x2",
                                        "mini2x2x2"]


# -- numerical parity of the sharded program (gloo, 4 processes) ------------------

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import get_arch, reduced_for_smoke
from repro_torch.launch.specs import shard_model, zero_extend_axes
from repro_torch.launch.steps import make_grad_step, make_train_step
from repro_torch.models.axes import param_axes
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import (default_rules, guard,
                                        param_shardings, placements_for,
                                        spec_for, use_rules)
from repro_torch.train.optimizer import AdamW, AdamWState, constant_lr

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shape = tuple(int(n) for n in sys.argv[4].split("x"))
torch.use_deterministic_algorithms(True)
dist.init_process_group("gloo", init_method=init, world_size=4, rank=rank)
try:
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    res = {}
    for arch in sys.argv[5:]:
        cfg = reduced_for_smoke(get_arch(arch))
        model = build_model(cfg, device="cpu")
        rules = default_rules(multi_pod=len(shape) == 3)
        rules.update(dict(cfg.sharding_overrides))
        axes = param_axes(model)
        params = dict(model.named_parameters())
        shapes = {n: tuple(p.shape) for n, p in params.items()}
        pl = param_shardings(axes, mesh, rules, shapes)
        shard_model(model, {n: distribute_tensor(p.detach(), mesh, pl[n])
                            for n, p in params.items()})
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        tgts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        bpl = placements_for(guard(spec_for(("batch", "seq"), rules),
                                   (4, 16), mesh), mesh)
        tok = distribute_tensor(torch.from_numpy(toks), mesh, bpl)
        tgt = distribute_tensor(torch.from_numpy(tgts), mesh, bpl)
        zpl = param_shardings(zero_extend_axes(axes), mesh, rules, shapes)
        zeros = lambda: {n: distribute_tensor(
            torch.zeros(shapes[n]), mesh, zpl[n]) for n in shapes}
        step0 = distribute_tensor(torch.zeros((), dtype=torch.int32), mesh,
                                  placements_for((), mesh))
        with use_rules(mesh, rules), implicit_replication():
            with torch.no_grad():
                logits, _ = model(tok)
            res[arch + "/logits"] = logits.full_tensor().numpy()
            params = dict(model.named_parameters())
            grads, _ = make_grad_step(model)(params, {"tokens": tok,
                                                      "targets": tgt})
            for n, g in grads.items():
                res[arch + "/g/" + n] = g.full_tensor().numpy()
            step = make_train_step(model, AdamW(constant_lr(1e-3)),
                                   grad_axes=axes)
            _, _, m = step(params, AdamWState(step0, zeros(), zeros()),
                           {"tokens": tok, "targets": tgt})
            res[arch + "/loss"] = np.asarray(m["loss"].full_tensor())
            for n, p in params.items():
                res[arch + "/p/" + n] = p.detach().full_tensor().numpy()
    if rank == 0:
        np.savez(out, **res)
finally:
    dist.destroy_process_group()
"""

PARITY_ARCHS = ["qwen2-1.5b", "olmoe-1b-7b"]
# (data, model) under the one-pod rules, and (pod, data, model) under the
# two-pod rules (the batch sharded over pod and data), each 4 processes
PARITY_MESHES = ["2x2", "2x1x2"]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def sharded_results(tmp_path_factory):
    """``get(mesh)``: rank 0's results of the 4 gloo processes on that
    mesh, run once per mesh."""
    runs = {}

    def get(mesh):
        if mesh not in runs:
            tmp = tmp_path_factory.mktemp("gloo")
            out = tmp / "rank0.npz"
            init = f"file://{tmp}/pg"
            procs = [subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(r), init, str(out),
                 mesh] + PARITY_ARCHS, env=_env(), cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(4)]
            errs = []
            for p in procs:
                _, err = p.communicate(timeout=300)
                errs.append(err)
            assert all(p.returncode == 0 for p in procs), "\n".join(
                e[-3000:] for e in errs)
            runs[mesh] = dict(np.load(out))
        return runs[mesh]

    return get


# The tolerance, of each tensor's largest absolute value: 100x float32's
# rounding over these reductions (the shards sum in another order).
RTOL = 1e-5
# Adam's first step is lr * g / (|g| + eps): an element whose gradient is
# below this share of its leaf's largest (near eps = 1e-8) moves by a
# float32-noise ratio, either way by up to 2 lr; everywhere else the
# step is decided and held to RTOL.
DECIDED = 1e-5
LR = 1e-3


def _close(got, want, where=None):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want)
    if where is not None:
        err = err[where]
    assert err.max(initial=0.0) <= RTOL * scale


@pytest.mark.parametrize("arch,mesh", [
    pytest.param(arch, mesh, id=arch if mesh == "2x2" else f"{arch}-{mesh}")
    for mesh in PARITY_MESHES for arch in PARITY_ARCHS])
def test_sharded_step_equals_one_process(arch, mesh, sharded_results):
    sharded_results = sharded_results(mesh)
    cfg = reduced_for_smoke(get_arch(arch))
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                            .astype(np.int32))
    tgts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                            .astype(np.int32))
    with torch.no_grad():
        logits, _ = model(toks)
    _close(sharded_results[arch + "/logits"], logits.numpy())
    params = dict(model.named_parameters())
    batch = {"tokens": toks, "targets": tgts}
    grads, _ = make_grad_step(model)(params, batch)
    for n, g in grads.items():
        _close(sharded_results[arch + "/g/" + n], g.numpy())
    opt = AdamW(constant_lr(LR))
    before = {n: p.detach().clone().numpy() for n, p in params.items()}
    _, _, m = make_train_step(model, opt)(params, opt.init(params), batch)
    _close(sharded_results[arch + "/loss"], m["loss"].numpy())
    for n, p in params.items():
        got, want = sharded_results[arch + "/p/" + n], p.detach().numpy()
        g = np.abs(grads[n].numpy())
        decided = g >= DECIDED * g.max()
        _close(got, want, decided)
        assert np.abs(got - before[n])[~decided].max(initial=0.0) <= \
            2 * LR * (1 + 0.1) + 1e-6
