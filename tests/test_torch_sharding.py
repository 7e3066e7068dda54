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
import functools
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
from repro_torch.launch.mesh import MINI, PRODUCTION, fake_mesh, mesh_name
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


@pytest.mark.parametrize("shape,axes,want", [
    # batch 32 on pod x data = 64 ranks: drop pod, one row per data rank
    ((32, 32768), ("batch", "seq"), ("data",)),
    ((256, 4096), ("batch", "seq"), (("pod", "data"),)),
    ((1, 524288), ("batch", "seq"), ()),
    # ZeRO moments: jamba's x_proj (96 wide) and a_log (16 wide) dims
    ((96,), ("zero",), ("data",)),
    ((16,), ("zero",), ()),
])
def test_divisibility_guard_two_pod(shape, axes, want):
    """On gpu2x32x8 a multi-axis entry loses mesh axes from the front
    until the rest divides the dimension, and is dropped only when none
    is left."""
    from torch.distributed.tensor import Replicate, Shard
    with fake_mesh(*PRODUCTION[True], device_type="cpu") as mesh:
        spec = TR.guard(TR.spec_for(axes, TR.default_rules(True)), shape,
                        mesh)
        assert spec == want
        pl = TR.placements_for(spec, mesh)
    for name, p in zip(("pod", "data", "model"), pl):
        dims = [i for i, part in enumerate(spec)
                if part is not None and name in TR._names(part)]
        assert p == (Shard(dims[0]) if dims else Replicate())
    if want == ("data",):
        assert pl == (Replicate(), Shard(0), Replicate())


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


# -- the divisibility guard at full width, leaf by leaf ------------------------

@functools.lru_cache(maxsize=None)
def _full_width(arch):
    """Every guarded leaf of ``arch`` at full width, shapes from the JAX
    package's ``eval_shape``: ``{label: {shape, axes, ref_shape,
    ref_axes, stacked}}``, labelled by the port's per-layer parameter
    names (``("param", name)``, its ZeRO moments ``("zero", name)``)
    and by each ``ALL_SHAPES`` batch leaf (``("batch", shape, leaf)``);
    ``ref_*`` is the reference's leaf, stacked over layers when
    ``stacked``."""
    import jax
    from repro.launch.specs import zero_extend_axes as ref_zero
    from repro.models.model import build_model as ref_build
    from repro_torch.models.axes import param_axes
    from repro_torch.launch.specs import ENC_FRAMES, zero_extend_axes
    ref_cfg = ref_archs()[arch]
    box = {}

    def init(k):
        p, box["a"] = ref_build(ref_cfg).init(k)
        return p

    shapes = dict(_tree_leaves(jax.eval_shape(init, jax.random.PRNGKey(0))))
    ref_axes = dict(_tree_leaves(box["a"], leaf=lambda a: isinstance(a,
                                                                     tuple)))
    ref_zero_axes = dict(_tree_leaves(ref_zero(box["a"]),
                                      leaf=lambda a: isinstance(a, tuple)))
    cfg = get_arch(arch)
    axes = param_axes(Model(cfg, torch.bfloat16, torch.device("meta")))
    zero = zero_extend_axes(axes)
    leaves = {}
    for name in axes:
        k, index, _ = tree_key(cfg, name)
        shape = tuple(shapes[k].shape)
        stacked = index is not None
        for kind, port, ref in (("param", axes, ref_axes),
                                ("zero", zero, ref_zero_axes)):
            leaves[(kind, name)] = dict(
                shape=shape[1:] if stacked else shape, axes=port[name],
                ref_shape=shape, ref_axes=ref[k], stacked=stacked)
    for s in ALL_SHAPES:
        batch = {"tokens": ((s.global_batch, s.seq_len), ("batch", "seq"))}
        if cfg.encoder_layers:
            batch["enc_input"] = ((s.global_batch, ENC_FRAMES, cfg.d_model),
                                  ("batch", None, "act_embed"))
        for leaf, (shape, ax) in batch.items():
            leaves[("batch", s.name, leaf)] = dict(
                shape=shape, axes=ax, ref_shape=shape, ref_axes=ax,
                stacked=False)
    return leaves


def _tree_leaves(tree, prefix=(), leaf=lambda a: False):
    for name, sub in tree.items():
        if isinstance(sub, dict) and not leaf(sub):
            yield from _tree_leaves(sub, prefix + (name,), leaf)
        else:
            yield prefix + (name,), sub


def _guard_diffs(arch, sizes, names):
    """The labels of ``_full_width(arch)`` whose port spec
    (``rules.guard``) differs from the JAX package's
    ``param_shardings`` on an abstract mesh of the same ``sizes``
    (its layers dim dropped for a stacked leaf), under each package's
    default rules and the config's overrides."""
    import jax
    from jax.sharding import AbstractMesh
    multi_pod = "pod" in names
    amesh = AbstractMesh(sizes, names)
    ref_rules = RR.default_rules(multi_pod)
    ref_rules.update(dict(ref_archs()[arch].sharding_overrides))
    rules = TR.default_rules(multi_pod)
    rules.update(dict(get_arch(arch).sharding_overrides))
    leaves = _full_width(arch)
    diffs = set()
    with fake_mesh(sizes, names, device_type="cpu") as mesh:
        for label, leaf in leaves.items():
            ref = RR.param_shardings(
                {"x": leaf["ref_axes"]}, amesh, ref_rules,
                {"x": jax.ShapeDtypeStruct(leaf["ref_shape"], "float32")})
            want = tuple(ref["x"].spec)[1 if leaf["stacked"] else 0:]
            got = TR.guard(TR.spec_for(leaf["axes"], rules), leaf["shape"],
                           mesh)
            if got != want:
                diffs.add(label)
    return diffs


def _moments(arch, suffix):
    """``("zero", name)`` of every parameter of ``arch`` ending in
    ``suffix``."""
    out = {label for label in _full_width(arch)
           if label[0] == "zero" and label[1].endswith(suffix)}
    assert out, suffix
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_guard_equals_reference_on_its_meshes(arch, mesh):
    """On the reference's own meshes, every parameter, ZeRO moment and
    batch leaf of every config at full width is placed as the JAX
    package places it, except jamba's 16-wide ``mixer.a_log`` moments
    on (2, 16, 16): they divide ``data`` (16) but not ``pod`` x
    ``data`` (32), so the port shards them over ``data`` where the
    reference replicates them (a deliberate difference)."""
    sizes, names = {"16x16": ((16, 16), ("data", "model")),
                    "2x16x16": ((2, 16, 16), ("pod", "data",
                                              "model"))}[mesh]
    want = set()
    if arch == "jamba-1.5-large-398b" and mesh == "2x16x16":
        want = _moments(arch, "mixer.a_log")
    assert _guard_diffs(arch, sizes, names) == want


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_guard_keeps_the_axes_that_divide_on_the_port_meshes(arch,
                                                             multi_pod):
    """On gpu32x8 and gpu2x32x8 the repaired guard parts from the
    reference's drop-the-whole-entry rule in exactly the prefill_32k
    batch (32 rows on pod x data = 64 ranks: sharded over data) and
    jamba's 96-wide ``mixer.x_proj`` ZeRO moments."""
    want = set()
    if multi_pod:
        want = {label for label in _full_width(arch)
                if label[:2] == ("batch", "prefill_32k")}
        if arch == "jamba-1.5-large-398b":
            want |= _moments(arch, "mixer.x_proj")
    assert _guard_diffs(arch, *PRODUCTION[multi_pod]) == want


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
                # where each gradient lies, beside the rules' shard
                res[arch + "/gpl/" + n] = np.array([str(q)
                                                    for q in g.placements])
                res[arch + "/gshape/" + n] = np.array(g.to_local().shape)
                res[arch + "/rpl/" + n] = np.array([str(q) for q in pl[n]])
                res[arch + "/rshape/" + n] = np.array(
                    params[n].to_local().shape)
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


@pytest.mark.parametrize("arch,mesh", [
    pytest.param(arch, mesh, id=arch if mesh == "2x2" else f"{arch}-{mesh}")
    for mesh in PARITY_MESHES for arch in PARITY_ARCHS])
def test_sharded_grads_keep_the_rules_shards(arch, mesh, sharded_results):
    """Every parameter gradient of ``make_grad_step`` (before any ZeRO
    constraint) is sharded as its parameter on each mesh dim the rules
    shard it on, never replicated there, and its local block is the
    parameter's shard."""
    res = sharded_results(mesh)
    names = [k.split("/gpl/", 1)[1] for k in res
             if k.startswith(arch + "/gpl/")]
    assert names
    for n in names:
        got = [str(q) for q in res[f"{arch}/gpl/{n}"]]
        want = [str(q) for q in res[f"{arch}/rpl/{n}"]]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if w.startswith("S("):
                assert g == w, (n, got, want)
        assert list(res[f"{arch}/gshape/{n}"]) == \
            list(res[f"{arch}/rshape/{n}"]), n


# -- the constraint's backward (gloo, 4 processes as a (2, 2) mesh) ---------------

_CONSTRAIN_WORKER = r"""
import contextlib
import functools
import json
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.base import get_arch, reduced_for_smoke
from repro_torch.launch.specs import shard_model
from repro_torch.models.axes import param_axes
from repro_torch.models.model import build_model, positions_like
from repro_torch.sharding.rules import (constrain, default_rules,
                                        param_shardings, sharded_param_grads,
                                        use_rules)

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, world_size=4, rank=rank)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = default_rules()
    res = {}
    # the whole of x and of the incoming gradient, equal on every rank
    x_full = torch.arange(24, dtype=torch.float32).reshape(4, 6) - 7.0
    g_full = (torch.arange(24, dtype=torch.float32).reshape(4, 6) * 3.0
              - 20.0)
    # a DTensor with placements pl whose whole is t: over a Partial mesh
    # dim the two ranks hold 1/4 and 3/4 of their shard (the sum is exact)
    def place(t, pl):
        local = distribute_tensor(t, mesh, [Replicate() if p.is_partial()
                                            else p for p in pl]).to_local()
        for i, p in enumerate(pl):
            if p.is_partial():
                local = local * (0.25, 0.75)[mesh.get_local_rank(i)]
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    cases = {
        # the forward is a no-op: x already has the rules' placements
        "noop-partial": ((Shard(0), Shard(1)), (Partial(), Partial())),
        "noop-replicated": ((Shard(0), Shard(1)), (Shard(0), Replicate())),
        # the forward redistributes x
        "redistribute-partial": ((Replicate(), Replicate()),
                                 (Partial(), Partial())),
        "redistribute-transposed": ((Shard(1), Shard(0)),
                                    (Replicate(), Shard(0))),
        # a partial sum reduced by the forward
        "partial-input": ((Partial(), Partial()), (Partial(), Replicate())),
    }
    with use_rules(mesh, rules):
        for name, (x_pl, g_pl) in cases.items():
            leaf = place(x_full, x_pl).detach().requires_grad_(True)
            x = leaf * 1.0 if name == "partial-input" else leaf
            y = constrain(x, "batch", "ff")
            seen = {}
            if y.grad_fn is not None:
                # what the output's node passes back toward x
                y.grad_fn.register_hook(
                    lambda gi, go, seen=seen: seen.update(node=gi[0]))
            y.backward(place(g_full, g_pl))
            node = seen.get("node", leaf.grad)
            res[name] = dict(
                out=[str(p) for p in y.placements],
                grad_fn=type(y.grad_fn).__name__,
                node=[str(p) for p in node.placements],
                node_full=node.full_tensor().tolist(),
                leaf=[str(p) for p in leaf.grad.placements],
                leaf_full=leaf.grad.full_tensor().tolist(),
                want=g_full.tolist())
    # no rules, or a plain tensor: x itself, no node
    xd = distribute_tensor(x_full, mesh, (Shard(0), Replicate())) \
        .requires_grad_(True)
    xp = x_full.clone().requires_grad_(True)
    plain = constrain(xd, "batch", "ff") is xd
    with use_rules(mesh, rules):
        plain = plain and constrain(xp, "batch", "ff") is xp
        with torch.no_grad():
            plain = plain and constrain(xd, "batch", None) is xd
    res["plain"] = plain and xd.grad_fn is None and xp.grad_fn is None

    # a parameter the rules shard over data (jamba's embed -> data), its
    # gradient a partial sum over data: reduce-scattered to its shard
    # before it accumulates, two backwards as two microbatches
    w_full = torch.arange(48, dtype=torch.float32).reshape(6, 8) / 8 - 2.5
    dy_full = [torch.arange(32, dtype=torch.float32).reshape(4, 8) - k
               for k in (9.0, 4.0)]
    for name, rs in (("hooked", dict(rules, embed="data")), ("bare", None)):
        w = distribute_tensor(w_full, mesh, (Shard(0), Replicate())) \
            .requires_grad_(True)
        with contextlib.ExitStack() as stack:
            if rs is not None:
                stack.enter_context(use_rules(mesh, rs))
            stack.enter_context(sharded_param_grads([w]))
            seen = []
            w.register_post_accumulate_grad_hook(
                lambda p: seen.append([str(q) for q in p.grad.placements]))
            for dy in dy_full:
                xd = distribute_tensor(x_full, mesh, (Shard(0), Replicate()))
                (xd @ w).backward(distribute_tensor(
                    dy, mesh, (Shard(0), Replicate())))
        res[f"param-{name}"] = dict(seen=seen, full=w.grad.full_tensor()
                                    .tolist())

    # one qwen2 decoder block's parameter gradients
    cfg = reduced_for_smoke(get_arch("qwen2-1.5b"))
    block = build_model(cfg, device="cpu").stack.layers[0]
    r = dict(rules, **dict(cfg.sharding_overrides))
    axes = param_axes(block)
    params = dict(block.named_parameters())
    pl = param_shardings(axes, mesh, r, {n: tuple(p.shape)
                                         for n, p in params.items()})
    shard_model(block, {n: distribute_tensor(p.detach(), mesh, pl[n])
                        for n, p in params.items()})
    block.requires_grad_(True)
    gen = torch.Generator().manual_seed(0)
    h = distribute_tensor(torch.randn(4, 16, cfg.d_model, generator=gen),
                          mesh, (Shard(0), Replicate()))
    with use_rules(mesh, r), implicit_replication():
        y, _ = block(h, positions_like(h))
        (y.float() ** 2).sum().backward()
    res["block"] = {
        n: dict(grad=[str(q) for q in p.grad.placements],
                rules=[str(q) for q in p.placements],
                local=list(p.grad.to_local().shape),
                shard=list(p.to_local().shape),
                dims={a: [q.dim] if q.is_shard() else []
                      for a, q in zip(mesh.mesh_dim_names,
                                      p.grad.placements)})
        for n, p in block.named_parameters()}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
finally:
    dist.destroy_process_group()
"""

# (x's placements, the incoming gradient's placements): the forward is
# a no-op (x already as the rules place it) or redistributes x, and the
# gradient arrives as a partial sum, replicated where the rules shard,
# or sharded on the other dim
CONSTRAIN_CASES = ["noop-partial", "noop-replicated", "redistribute-partial",
                   "redistribute-transposed", "partial-input"]
# what redistribute's own backward leaves on x: its placements, a
# partial sum taken as replicated
LEAF_PLACEMENTS = {"noop-partial": ["S(0)", "S(1)"],
                   "noop-replicated": ["S(0)", "S(1)"],
                   "redistribute-partial": ["R", "R"],
                   "redistribute-transposed": ["S(1)", "S(0)"],
                   "partial-input": ["R", "R"]}


@pytest.fixture(scope="module")
def constrain_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("constrain")
    out = tmp / "rank0.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CONSTRAIN_WORKER, str(r),
         f"file://{tmp}/pg", str(out)], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", CONSTRAIN_CASES)
def test_constrain_backward_places_the_gradient(case, constrain_results):
    """``constrain(x, "batch", "ff")`` on a (4, 6) DTensor: the output
    has the rules' placements, and the gradient the constraint passes
    back to its input has them too (a partial sum reduced, the dim the
    rules shard split), whether the forward redistributed or not; the
    whole gradient equals the plain tensor's."""
    r = constrain_results[case]
    want_pl = ["S(0)", "S(1)"]
    assert r["out"] == want_pl
    assert r["grad_fn"] == "_ConstrainGradBackward"
    assert r["node"] == want_pl
    assert r["leaf"] == LEAF_PLACEMENTS[case]
    x = (torch.arange(24, dtype=torch.float32).reshape(4, 6) - 7.0) \
        .requires_grad_(True)
    g = torch.arange(24, dtype=torch.float32).reshape(4, 6) * 3.0 - 20.0
    y = TR.constrain(x, "batch", "ff")
    assert y is x
    y.backward(g)
    assert r["want"] == x.grad.tolist()
    assert r["node_full"] == x.grad.tolist()
    assert r["leaf_full"] == x.grad.tolist()


def test_constrain_adds_no_node_without_rules_or_dtensor(constrain_results):
    """A DTensor without rules, a plain tensor under rules and a DTensor
    under ``no_grad`` come back as themselves, with no autograd node."""
    assert constrain_results["plain"] is True


def test_data_sharded_param_grads_are_reduce_scattered(constrain_results):
    """``sharded_param_grads``: a parameter the rules shard over ``data``
    (as ``embed -> data`` does) gets each microbatch's gradient, a
    partial sum over ``data``, reduce-scattered to its own shard before
    autograd accumulates it, and the accumulated whole equals the plain
    tensor's; without rules the hook is not installed and the gradient
    stays a partial sum."""
    hooked, bare = (constrain_results[f"param-{k}"]
                    for k in ("hooked", "bare"))
    assert hooked["seen"] == [["S(0)", "R"]] * 2
    assert bare["seen"] == [["P(sum)", "R"]] * 2
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) - 7.0
    w = (torch.arange(48, dtype=torch.float32).reshape(6, 8) / 8 - 2.5) \
        .requires_grad_(True)
    for k in (9.0, 4.0):
        (x @ w).backward(torch.arange(32, dtype=torch.float32)
                         .reshape(4, 8) - k)
    assert hooked["full"] == w.grad.tolist()
    assert bare["full"] == w.grad.tolist()


# The JAX package's gradient of one qwen2 decoder block (attention and
# FFN, no embedding lookup) compiled under its rules on a (2, 2) mesh of
# host devices with GSPMD's (Auto) axes: for each leaf, the tensor dims
# each mesh axis splits in the compiled gradient's output sharding.
_REF_BLOCK = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ATTN, all_archs, reduced_for_smoke
from repro.models.transformer import apply_block, init_block
from repro.sharding.rules import default_rules, param_shardings, use_rules

cfg = reduced_for_smoke(all_archs()["qwen2-1.5b"])
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
rules = default_rules()
rules.update(dict(cfg.sharding_overrides))
params, axes = init_block(jax.random.PRNGKey(0), cfg, ATTN, False,
                          jnp.float32)
b, s = 4, 16
x = jnp.asarray(np.random.default_rng(0).normal(
    size=(b, s, cfg.d_model)).astype(np.float32))
pos = jnp.broadcast_to(jnp.arange(s), (b, s))

def loss(p, x, pos):
    y, _ = apply_block(p, x, cfg, ATTN, False, pos)
    return jnp.sum(jnp.square(y.astype(jnp.float32)))

rows = NamedSharding(mesh, P("data"))
with use_rules(mesh, rules):
    grad = jax.jit(jax.grad(loss), in_shardings=(
        param_shardings(axes, mesh, rules, params), rows, rows))
    compiled = grad.lower(params, x, pos).compile()
devs = np.asarray(mesh.devices)
out = {}
for path, sh in jax.tree_util.tree_flatten_with_path(
        compiled.output_shardings)[0]:
    keys = [str(getattr(k, "key", k)) for k in path]
    leaf = params
    for k in keys:
        leaf = leaf[k]
    index = sh.devices_indices_map(leaf.shape)
    dims = {}
    for i, name in enumerate(mesh.axis_names):
        other = [0] * devs.ndim
        other[i] = 1
        a, c = index[devs[(0,) * devs.ndim]], index[devs[tuple(other)]]
        dims[name] = [d for d in range(leaf.ndim) if a[d] != c[d]]
    out[".".join(keys)] = dims
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_block_grads():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_BLOCK], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=False, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_block_grad_shardings_equal_reference(ref_block_grads,
                                              constrain_results):
    """One qwen2 decoder block's parameter gradients in 4 gloo processes
    on a (2, 2) mesh: each mesh axis splits the same dims of each leaf
    as in the reference's compiled gradient (a partial sum splits none),
    and each local block is the parameter's shard."""
    got = constrain_results["block"]
    assert set(got) == set(ref_block_grads)
    for name, r in got.items():
        assert r["dims"] == ref_block_grads[name], name
        assert r["local"] == r["shard"], name
