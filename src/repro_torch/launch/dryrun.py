"""Dry-run of the sharded steps on the production H100 meshes (the
PyTorch counterpart of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell this traces the real
step (the train step for training shapes, prefill/serve steps for
inference shapes) as rank 0 of the mesh runs it, on DTensor stand-ins
whose local tensors are fake (``FakeTensorMode``: no allocation):

  single pod ``gpu32x8``:    (data=32, model=8)         = 256 H100s
  multi-pod  ``gpu2x32x8``:  (pod=2, data=32, model=8)  = 512 H100s

over PyTorch's fake process group (``launch.mesh``). The model is built
at bf16 on the ``meta`` device and its parameters replaced by sharded
stand-ins (the logical-axis rules plus ``cfg.sharding_overrides``);
DTensor desugars each op into rank 0's local ops and collectives, which
``roofline.CostCounter`` counts. Each cell writes a JSON record with the
reference's keys under ``artifacts/dryrun/``: ``memory_analysis`` holds
rank 0's argument bytes (its shards of the parameters and of the
optimizer state, batch or cache), output bytes (what the step returns that it did not
get) and temp bytes (the peak of the step's own allocations, less the
outputs); ``cost_analysis`` and ``roofline`` come from the counter;
``grad_blocks`` (train steps) the largest parameter gradient rank 0
holds and every one held above the shard its rules give
(``GradBlocks``).

Run as ``python -m repro_torch.launch.dryrun [--arch A] [--shape S]
[--multi-pod | --both-meshes] [--mini] [--device cpu] [--out DIR]``.
The fake tensors live on the card's device type unless ``--device
cpu``; a CUDA device must be present for the default, as for every
entry point of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import (ALL_SHAPES, all_archs, get_arch,
                            reduced_for_smoke, shapes_for,
                            skipped_shapes_for)
from ..kernels.ops import resolve_device
from ..models.model import Model
from ..sharding.rules import default_rules, use_rules
from ..train.optimizer import AdamW, constant_lr
from . import roofline as RL
from .mesh import MINI, PRODUCTION, fake_mesh, mesh_name
from .specs import (batch_specs, opt_state_specs, param_specs,
                    prefill_input_specs, serve_input_specs, shard_model)
from .steps import make_prefill_step, make_serve_step, make_train_step

ARTIFACT_DIR = os.path.join("artifacts", "dryrun")

# Collective bytes an op must have issued to be listed as one whose
# operands DTensor gathered or reduced (printed per cell).
REDISTRIBUTED_MIN_BYTES = 1 << 20


def grad_accum_for(cfg, shape, mesh_shape: Dict[str, int]) -> int:
    """The reference's microbatching rule: a per-microbatch local batch
    of about 1 (d_model >= 8192), 2 (>= 4096) or 4 rows."""
    data_shards = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    local_b = max(shape.global_batch // data_shards, 1)
    target = 1 if cfg.d_model >= 8192 else (2 if cfg.d_model >= 4096
                                            else 4)
    grad_accum = max(1, local_b // target)
    while shape.global_batch % grad_accum != 0:
        grad_accum //= 2
    return grad_accum


def _storage_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            local = getattr(t, "_local_tensor", t)
            st = local.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def _leaves(x):
    return torch.utils._pytree.tree_flatten(x)[0]


class GradBlocks:
    """Each parameter's gradient as rank 0 holds it when autograd
    accumulates it into ``.grad`` (before the step's ZeRO constraint),
    against the parameter's own shard, which the rules place: under
    ``with GradBlocks(model) as gb:`` a hook per parameter records the
    most bytes its local gradient held, its placements and the mesh
    dims on which it is not sharded as its parameter is, where it is
    *above* its shard (replicated there, or a partial sum). The hooks
    and the parameters are dropped on exit: only names and numbers are
    kept."""

    def __init__(self, model: torch.nn.Module) -> None:
        self.params = dict(model.named_parameters())
        self.held: Dict[str, Dict] = {}
        self._handles: list = []

    @staticmethod
    def _local(t: torch.Tensor) -> torch.Tensor:
        return getattr(t, "_local_tensor", t)

    def _hook(self, name: str, p: torch.Tensor) -> None:
        g = self._local(p.grad)
        nbytes = g.numel() * g.element_size()
        if name in self.held and nbytes < self.held[name]["bytes"]:
            return
        got = tuple(getattr(p.grad, "placements", ()))
        above = [dim for dim, want, have in zip(
            p.device_mesh.mesh_dim_names, p.placements, got, strict=True)
            if want.is_shard() and have != want] if got else []
        self.held[name] = dict(
            leaf=name, bytes=nbytes,
            shard_bytes=self._local(p).numel() * g.element_size(),
            placements=[str(q) for q in got], above=above)

    def __enter__(self) -> "GradBlocks":
        self._handles = [p.register_post_accumulate_grad_hook(
            lambda p, n=n: self._hook(n, p))
            for n, p in self.params.items() if p.requires_grad]
        return self

    def __exit__(self, *exc) -> None:
        for h in self._handles:
            h.remove()
        self._handles, self.params = [], {}

    def record(self) -> Optional[Dict]:
        """``None`` when no gradient was formed (an inference step);
        else the largest block (``leaf``, ``bytes``, ``shard_bytes``: the
        parameter's shard at the gradient's dtype, ``placements``) and
        every leaf held above its shard (``above_shard``)."""
        if not self.held:
            return None
        rows = sorted(self.held.values(), key=lambda r: -r["bytes"])
        return dict(largest=rows[0],
                    above_shard=[r for r in rows if r["above"]])


def cell_config(arch_name: str, shape_name: str, mini: bool):
    """(cfg, shape) of a cell: ``mini`` reduces the config and scales
    the shape as the reference's CI variant does."""
    cfg = get_arch(arch_name)
    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    if mini:
        cfg = dataclasses.replace(reduced_for_smoke(cfg), name=cfg.name)
        shape = dataclasses.replace(
            shape, seq_len=256,
            global_batch=8 if shape.global_batch > 1 else 1)
    return cfg, shape


def build_step(cfg, shape, mesh, rules, kind: str,
               grad_accum: Optional[int] = None):
    """Rank 0's sharded model and step for one cell, on stand-ins made
    in the current mode (fake or real). Returns ``(model, step, args,
    grad_accum)``; ``step(*args)`` runs the step. A train step takes
    ``grad_accum`` microbatches (default: the reference's rule)."""
    model = Model(cfg, torch.bfloat16, torch.device("meta"))
    p_specs, p_axes = param_specs(model, mesh, rules)
    shard_model(model, p_specs)
    if kind == "train":
        if grad_accum is None:
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))
            grad_accum = grad_accum_for(cfg, shape, sizes)
        step = make_train_step(model, AdamW(learning_rate=constant_lr(1e-4)),
                               grad_accum=grad_accum, grad_axes=p_axes)
        args = (dict(model.named_parameters()),
                opt_state_specs(p_specs, mesh, p_axes, rules),
                batch_specs(cfg, shape, mesh, rules))
    elif kind == "prefill":
        step = make_prefill_step(model, max_seq=shape.seq_len)
        args = prefill_input_specs(model, shape, mesh, rules)
    else:
        step = make_serve_step(model)
        args = serve_input_specs(model, shape, mesh, rules)
    return model, step, args, grad_accum or 1


def run_step(step, args, mesh, rules, counter: RL.CostCounter,
             held=()):
    """Run ``step(*args)`` as rank 0 under the rules and ``counter``;
    returns ``(outputs, argument bytes, output bytes, temp bytes)``. The
    arguments' bytes include ``held``, tensors the step uses without
    taking them (a model's parameters, which the reference passes)."""
    inputs = _leaves(args) + list(held)
    arg_bytes = _storage_bytes(inputs)
    arg_ids = {id(getattr(t, "_local_tensor", t).untyped_storage())
               for t in inputs if isinstance(t, torch.Tensor)}
    with use_rules(mesh, rules), implicit_replication(), counter:
        counter.reset_peak()
        out = step(*args)
    fresh = [t for t in _leaves(out) if isinstance(t, torch.Tensor)
             and id(getattr(t, "_local_tensor", t).untyped_storage())
             not in arg_ids]
    out_bytes = _storage_bytes(fresh)
    return out, arg_bytes, out_bytes, max(counter.peak - out_bytes, 0)


def _trace(cfg, shape, multi_pod: bool, mini: bool, dev, kind: str,
           grad_accum: Optional[int] = None) -> Dict:
    """Rank 0's counted step of one configuration: the counter's totals,
    the argument / output / temporary bytes and the timings."""
    shp, names = (MINI if mini else PRODUCTION)[multi_pod]
    rules = default_rules(multi_pod=multi_pod)
    rules.update(dict(cfg.sharding_overrides))
    with fake_mesh(shp, names, device_type=dev.type) as mesh:
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            model, step, args, grad_accum = build_step(
                cfg, shape, mesh, rules, kind, grad_accum)
            t_build = time.time() - t0
            counter = RL.CostCounter(RL.group_names(mesh))
            t0 = time.time()
            with GradBlocks(model) as grads:
                _, arg_b, out_b, temp_b = run_step(
                    step, args, mesh, rules, counter,
                    held=list(model.parameters()))
            t_trace = time.time() - t0
        chips = mesh.size()
    return dict(flops=counter.flops, bytes=counter.bytes,
                int_ops=counter.int_ops, coll_bytes=dict(counter.coll_bytes),
                coll_counts=dict(counter.coll_counts), arg=arg_b,
                out=out_b, temp=temp_b, t_build=t_build, t_trace=t_trace,
                chips=chips, grad_accum=grad_accum,
                redistributed={op: dict(kinds) for op, kinds in
                               counter.coll_by_op.items()},
                top_ops=counter.explain(), grads=grads.record())


def _extrapolate(points: Dict, depth: int, accum: int):
    """Each additive total of rank 0's step at ``depth`` layers and
    ``accum`` microbatches, bilinear in the two from the traced points
    ``{(layers, microbatches): totals}`` (every block period, and every
    microbatch, runs the same ops); the temporaries' peak linear in
    depth at the most microbatches traced, and at least the largest
    traced."""
    ds = sorted({d for d, _ in points})
    ms = sorted({m for _, m in points})
    x = (depth - ds[0]) / (ds[-1] - ds[0]) if len(ds) > 1 else 0.0
    y = (accum - ms[0]) / (ms[-1] - ms[0]) if len(ms) > 1 else 0.0

    def f(d, m, get):
        return get(points[(ds[d], ms[m])])

    def value(get):
        v = f(0, 0, get)
        if len(ds) > 1:
            v += x * (f(1, 0, get) - f(0, 0, get))
        if len(ms) > 1:
            v += y * (f(0, 1, get) - f(0, 0, get))
        if len(ds) > 1 and len(ms) > 1:
            v += x * y * (f(1, 1, get) - f(1, 0, get) - f(0, 1, get)
                          + f(0, 0, get))
        return v

    last = points[(ds[-1], ms[-1])]
    out = {k: value(lambda p, k=k: p[k])
           for k in ("flops", "bytes", "int_ops", "arg", "out")}
    # the peak of a sequence of microbatches is the last one's: the
    # temporaries grow with depth only (the most microbatches traced),
    # and never below a traced peak (a transient, not the activations
    # saved per layer, can set the peak of the shallower trace)
    deep = [points[(d, ms[-1])]["temp"] for d in ds]
    out["temp"] = max(deep[0] + x * (deep[-1] - deep[0]), *deep)
    for key in ("coll_bytes", "coll_counts"):
        names = set().union(*(p[key] for p in points.values()))
        out[key] = {n: value(lambda p, n=n, key=key: p[key].get(n, 0))
                    for n in names}
    out["coll_counts"] = {n: int(round(c))
                          for n, c in out["coll_counts"].items()}
    out.update(t_build=sum(p["t_build"] for p in points.values()),
               t_trace=sum(p["t_trace"] for p in points.values()),
               chips=last["chips"], grad_accum=accum,
               redistributed=last["redistributed"], top_ops=last["top_ops"],
               grads=last.get("grads"))
    return out


def trace_cell(arch_name: str, shape_name: str, multi_pod: bool,
               mini: bool = False, device: Optional[str] = None,
               step_override: str = "", sample: bool = False) -> Dict:
    """Trace one (arch, shape, mesh) cell as rank 0 on fake tensors;
    returns the record. ``mini``: reduced config on a (2,2[,2]) mesh
    with scaled shapes -- the CI-runnable version of the same code
    path. ``device=None`` means CUDA (and raises without a card).

    ``sample``: trace one and two block periods of layers (and, for a
    train step of more than two microbatches, one and two microbatches)
    at full width, and extrapolate the totals to the config's depth and
    microbatches (``_extrapolate``); the record lists the traced points
    under ``"traced"``. For deep configs whose full trace takes many
    minutes (a dry-run dispatches every op of every layer)."""
    dev = resolve_device(device)
    cfg, shape = cell_config(arch_name, shape_name, mini)
    kind = step_override or shape.kind
    name = mesh_name(multi_pod, mini)
    period, depth = len(cfg.block_pattern), cfg.num_layers
    if sample and depth > 2 * period:
        shp = (MINI if mini else PRODUCTION)[multi_pod]
        accum = 1
        if kind == "train":
            accum = grad_accum_for(cfg, shape, dict(zip(shp[1], shp[0],
                                                        strict=True)))
        mbs = (1, 2) if accum > 2 else (accum,)
        points = {}
        for layers in (period, 2 * period):
            for m in mbs:
                sub = dataclasses.replace(cfg, num_layers=layers)
                sub_shape = dataclasses.replace(
                    shape, global_batch=shape.global_batch // accum * m)
                points[(layers, m)] = _trace(sub, sub_shape, multi_pod,
                                             mini, dev, kind, m)
        raw = _extrapolate(points, depth, accum)
        traced = sorted(points)
    else:
        raw = _trace(cfg, shape, multi_pod, mini, dev, kind)
        traced = [(depth, raw["grad_accum"])]
    mem_gb = (raw["arg"] + raw["out"] + raw["temp"]) / 1e9
    rl = RL.Roofline(
        arch=arch_name, shape=shape_name, mesh=name, chips=raw["chips"],
        flops_per_chip=raw["flops"], bytes_per_chip=raw["bytes"],
        coll_bytes_per_chip=sum(raw["coll_bytes"].values()),
        coll_counts=raw["coll_counts"],
        model_flops=RL.model_flops_for(cfg, shape),
        memory_per_device_gb=mem_gb, coll_bytes_by_dim=raw["coll_bytes"],
        int_ops_per_chip=raw["int_ops"])
    return {
        "arch": arch_name, "shape": shape_name, "mesh": name,
        "kind": kind, "chips": raw["chips"], "device": dev.type,
        "grad_accum": raw["grad_accum"], "traced": traced,
        "lower_s": round(raw["t_build"], 2),
        "compile_s": round(raw["t_trace"], 2),
        "memory_analysis": {
            "argument_size_gb": raw["arg"] / 1e9,
            "output_size_gb": raw["out"] / 1e9,
            "temp_size_gb": raw["temp"] / 1e9,
            "generated_code_size_mb": 0.0,
        },
        "cost_analysis": {
            "flops_raw": raw["flops"],
            "bytes_accessed_raw": raw["bytes"],
        },
        "roofline": rl.to_dict(),
        "hlo_bytes": 0,
        "redistributed_ops": {
            op: kinds for op, kinds in raw["redistributed"].items()
            if sum(kinds.values()) >= REDISTRIBUTED_MIN_BYTES},
        "top_ops": raw["top_ops"],
        "grad_blocks": raw["grads"],
    }


def cell_list(multi_pod: bool):
    cells = []
    for name, cfg in sorted(all_archs().items()):
        for shape in shapes_for(cfg):
            cells.append((name, shape.name))
    return cells


def format_record(rec: Dict) -> str:
    r = rec["roofline"]
    return (f"trace={rec['compile_s']}s "
            f"mem={r['memory_per_device_gb']:.3f}GB/device "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"coll={r['collective_s']:.4f}s dominant={r['dominant']}")


def format_grads(blocks: Dict) -> str:
    """One line for a record's ``grad_blocks``."""
    big = blocks["largest"]
    above = ", ".join(f"{r['leaf']} {r['bytes']} B (shard {r['shard_bytes']}"
                      f" B, {r['placements']})"
                      for r in blocks["above_shard"])
    return (f"largest parameter gradient {big['leaf']} {big['bytes']} B per "
            f"rank (rules' shard {big['shard_bytes']} B, {big['placements']});"
            f" {len(blocks['above_shard'])} above their shard"
            + (f": {above}" if above else ", every leaf at its rules' shard"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mini", action="store_true",
                    help="reduced configs on a tiny mesh (CI)")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: "
                         "cuda; 'cpu' to trace without a card)")
    ap.add_argument("--sample", action="store_true",
                    help="trace one and two block periods (and "
                         "microbatches) and extrapolate to full depth")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = cell_list(False)
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]

    failures = 0
    for multi_pod in meshes:
        name = mesh_name(multi_pod, args.mini)
        for arch_name, shape_name in cells:
            out_path = os.path.join(
                args.out, f"{arch_name}__{shape_name}__{name}.json")
            if os.path.exists(out_path):
                print(f"[skip] {arch_name} x {shape_name} x {name}"
                      " (artifact exists)", flush=True)
                continue
            print(f"[dryrun] {arch_name} x {shape_name} x {name}",
                  flush=True)
            try:
                rec = trace_cell(arch_name, shape_name, multi_pod,
                                 mini=args.mini, device=args.device,
                                 sample=args.sample)
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=1)
                print("  ok: " + format_record(rec), flush=True)
                if rec["grad_blocks"]:
                    print("  " + format_grads(rec["grad_blocks"]),
                          flush=True)
                for op, kinds in rec["redistributed_ops"].items():
                    print(f"  redistributed for {op}: " + ", ".join(
                        f"{k} {v / 1e6:.1f} MB" for k, v in kinds.items()),
                        flush=True)
            except Exception:
                failures += 1
                print(f"  FAILED:\n{traceback.format_exc()}", flush=True)
    # record the per-brief skips
    skips = []
    for name, cfg in sorted(all_archs().items()):
        for shape, reason in skipped_shapes_for(cfg):
            skips.append({"arch": name, "shape": shape.name,
                          "reason": reason})
    with open(os.path.join(args.out, "skips.json"), "w") as f:
        json.dump(skips, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
