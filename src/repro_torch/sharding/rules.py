"""Logical-axis sharding: one model definition, any mesh (the PyTorch
counterpart of ``repro.sharding.rules``).

Parameters and activations are annotated with *logical* axis names
("embed", "ff", "heads", "experts", "batch", ...). A rule set maps
logical names to mesh axes; ``constrain`` redistributes a ``DTensor``
to the placements the rules give when a rule set is active, and its
gradient to the same placements (the transpose of JAX's sharding
constraint is that constraint), and is a no-op otherwise (single-device
runs never touch the mesh machinery: a plain tensor comes back as it
is).

Default rules implement the production layout:
  batch        -> (pod, data)   [DP across pods and the data axis]
  ff/heads/... -> model         [TP: Megatron-style column/row splits]
  experts      -> model         [EP: expert parallelism for MoE]
  kv_seq       -> data          [SP: sequence-sharded KV cache, decode]

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per tensor dimension, ``None``, a mesh-axis name or a tuple of names,
trailing ``None`` entries trimmed. ``placements_for`` turns it into
``DTensor`` placements on a ``DeviceMesh`` with named dimensions: each
mesh axis named in entry ``i`` gets ``Shard(i)``, every other axis
``Replicate()``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard,
                                      zeros as dtensor_zeros)
from torch.distributed.tensor.experimental import local_map

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# The active (mesh, rules), innermost last. A process-wide stack, not a
# thread-local one: autograd runs a CUDA backward in its own device
# thread, and a checkpointed region recomputed there must see the rules
# its forward ran under.
_stack: list = []


def default_rules(multi_pod: bool = False) -> Dict[str, MeshAxes]:
    dp: MeshAxes = ("pod", "data") if multi_pod else "data"
    return {
        # activations
        "batch": dp,
        "seq": None,
        "kv_seq": "data",          # sequence-sharded cache for B=1 decode
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",   # only when kv_heads divides the axis
        "act_ff": "model",
        # parameters
        "embed": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "ff_expert": None,         # expert-internal dim stays local
        "experts": "model",
        "experts_r": None,         # router output dim (tiny) replicated
        "ssm_inner": "model",
        "layers": None,
        # ZeRO: optimizer state / grad accumulators shard their largest
        # replicated dim over the data axis (pod included when present)
        "zero": dp,
    }


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, MeshAxes]):
    """Activate ``rules`` on ``mesh`` (a ``DeviceMesh`` with named
    dimensions) for ``constrain``."""
    _stack.append((mesh, rules))
    try:
        yield
    finally:
        _stack.pop()


def active():
    """``(mesh, rules)`` of the innermost ``use_rules``, else ``None``."""
    return _stack[-1] if _stack else None


def spec_for(axes: Sequence[Optional[str]],
             rules: Mapping[str, MeshAxes]) -> Spec:
    """Logical axes tuple -> spec tuple, dropping unknown names."""
    parts = []
    used = set()

    def resolve(name):
        if name is None:
            return None
        target = rules.get(name)
        if target is None:
            return None
        # avoid using one mesh axis twice in a spec
        flat = (target,) if isinstance(target, str) else tuple(target)
        flat = tuple(a for a in flat if a not in used)
        if not flat:
            return None
        used.update(flat)
        return flat if len(flat) > 1 else flat[0]

    for name in axes:
        parts.append(resolve(name))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape, strict=True))


def _names(part: MeshAxes) -> Tuple[str, ...]:
    return (part,) if isinstance(part, str) else tuple(part)


def _divides(part: MeshAxes, dim: int, sizes: Mapping[str, int]
             ) -> MeshAxes:
    """``part``, or what is left of it once mesh axes are dropped from
    the front (outermost first) until their product divides ``dim``;
    ``None`` when none is left."""
    names = _names(part)
    while names and dim % math.prod(sizes[n] for n in names) != 0:
        names = names[1:]
    if not names:
        return None
    return names if len(names) > 1 else names[0]


def guard(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """The divisibility guard: a mapped mesh axis that does not evenly
    divide the tensor dimension is dropped (e.g. 2 KV heads cannot
    shard over an 8-way model axis -- they stay replicated for that
    arch). An entry that names several mesh axes loses them from the
    front, outermost first, until the product of the rest divides: the
    port's two-pod mesh (pod=2, data=32) cannot shard a batch of 32
    over both, but shards it over ``data`` and replicates it over
    ``pod``, as the reference's (pod=2, data=16) shards it whole. The
    reference drops the whole entry; on its own meshes the two rules
    differ only where a dimension divides ``data`` but not ``pod`` x
    ``data`` (jamba's 16-wide ``a_log`` moments under ``zero``)."""
    sizes = mesh_sizes(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    fixed = [None if part is None else _divides(part, dim, sizes)
             for dim, part in zip(shape, parts, strict=True)]
    while fixed and fixed[-1] is None:
        fixed.pop()
    return tuple(fixed)


def placements_for(spec: Spec, mesh) -> Tuple[Placement, ...]:
    """Spec tuple -> one placement per mesh dimension: ``Shard(i)`` on
    each mesh axis that entry ``i`` names, ``Replicate()`` elsewhere."""
    out = [Replicate()] * mesh.ndim
    for i, part in enumerate(spec):
        if part is None:
            continue
        for name in _names(part):
            out[mesh.mesh_dim_names.index(name)] = Shard(i)
    return tuple(out)


class _ConstrainGrad(torch.autograd.Function):
    """Identity whose backward redistributes the gradient to the
    placements given at forward time (a partial sum reduced, an axis
    the rules shard split): the transpose of a sharding constraint is
    the same constraint. The mesh and placements travel in ``ctx``, not
    through ``active()``: autograd may run the backward, or recompute a
    checkpointed period, in its own thread."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Apply a logical sharding constraint if rules are active.

    ``x`` itself comes back when no rules are active or ``x`` is not a
    ``DTensor``; otherwise ``x`` redistributed to the guarded spec's
    placements (a partial sum is reduced on the way). Where autograd
    records, the gradient flowing back through the constraint is
    redistributed to the same placements, as JAX transposes
    ``with_sharding_constraint``, before the redistribution's own
    backward takes it to ``x``'s: otherwise DTensor places every
    backward op by its own cost model."""
    ctx = active()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = guard(spec_for(axes, rules), x.shape, mesh)
    placements = placements_for(spec, mesh)
    y = x if tuple(x.placements) == placements else \
        x.redistribute(mesh, placements)
    if not (torch.is_grad_enabled() and y.requires_grad):
        return y
    return _ConstrainGrad.apply(y, mesh, placements)


def _reduce_scatter_grad(mesh, placements, dims, grad):
    got = list(grad.placements)
    if not any(got[i].is_partial() for i in dims):
        return None
    for i in dims:
        if got[i].is_partial():
            got[i] = placements[i]
    return grad.redistribute(mesh, tuple(got))


@contextlib.contextmanager
def sharded_param_grads(params):
    """Under active rules, each ``DTensor`` parameter that the rules
    shard over a mesh dim ``"batch"`` maps to (jamba's ``embed ->
    data``) gets each gradient contribution that is a partial sum there
    reduce-scattered to its shard before autograd accumulates it into
    ``.grad``, as GSPMD does in the backward of such a layout: it would
    otherwise stay whole along that dim until the step's ZeRO
    constraint. A no-op without rules and for plain tensors."""
    ctx = active()
    handles = []
    if ctx is not None:
        batch = _names(ctx[1].get("batch") or ())
        for p in params:
            if not (isinstance(p, DTensor) and p.requires_grad):
                continue
            dims = [i for i, (name, q) in enumerate(zip(
                p.device_mesh.mesh_dim_names, p.placements, strict=True))
                if name in batch and q.is_shard()]
            if dims:
                handles.append(p.register_hook(functools.partial(
                    _reduce_scatter_grad, p.device_mesh,
                    tuple(p.placements), dims)))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def zeros(shape: Sequence[int], *axes: Optional[str],
          dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.zeros(shape)``, or under active rules a ``DTensor`` of
    zeros placed by ``axes`` (guarded), each rank allocating only its
    shard: a buffer a step creates (a decode cache) that would
    otherwise be replicated whole on every rank."""
    ctx = active()
    if ctx is None:
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    mesh, rules = ctx
    spec = guard(spec_for(axes, rules), shape, mesh)
    return dtensor_zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                         placements=placements_for(spec, mesh))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_inputs(fn):
    """``fn`` for ``local_map``: its tensor inputs' gradients leave the
    region contiguous. DTensor describes a local gradient by the global
    tensor's (contiguous) strides, so a transposed local gradient (an
    einsum's backward) would make a later reshape of it a failing
    view."""
    def wrapped(*args):
        return fn(*(_ContiguousGrad.apply(a)
                    if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))

    return wrapped


def shard_local(fn, template: DTensor, dims: Tuple[int, int],
                in_dims, out_dims):
    """``fn`` run by ``local_map`` on each rank's shards, for a region
    whose rows (a batch dimension) and channels (heads, inner channels)
    never meet another rank's: a recurrent scan over time, say, which
    DTensor cannot propagate through.

    ``template``'s placements decide the layout: the mesh dims that
    shard its dimension ``dims[0]`` (rows) or ``dims[1]`` (channels)
    shard each input's and output's row and channel dimension, given
    per tensor as ``(row dim or None, channel dim or None)`` in
    ``in_dims`` / ``out_dims``; everything else is replicated. An input
    without the row (or channel) dimension gets its gradient as a
    partial sum over the mesh dims that shard it."""
    pl = tuple(template.placements)

    def place(row, chan, grad=False):
        out = []
        for p in pl:
            if p.is_shard(dims[0]):
                out.append(Shard(row) if row is not None
                           else Partial() if grad else Replicate())
            elif p.is_shard(dims[1]):
                out.append(Shard(chan) if chan is not None
                           else Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return out

    return local_map(
        local_inputs(fn), out_placements=tuple(place(*d) for d in out_dims),
        in_placements=tuple(place(*d) for d in in_dims),
        in_grad_placements=tuple(place(*d, grad=True) for d in in_dims),
        device_mesh=template.device_mesh, redistribute_inputs=True)


def param_shardings(axes_tree: Mapping[str, Optional[tuple]], mesh,
                    rules: Mapping[str, MeshAxes],
                    shapes_tree: Optional[Mapping[str, Sequence[int]]]
                    = None) -> Dict[str, Tuple[Placement, ...]]:
    """Map ``{name: logical axes}`` to ``{name: placements}``.

    With ``shapes_tree`` (``{name: shape}``), applies the same
    divisibility guard as ``constrain``; a name without axes (``None``)
    is replicated."""
    out = {}
    for name, axes in axes_tree.items():
        if axes is None:
            out[name] = placements_for((), mesh)
            continue
        spec = spec_for(axes, rules)
        if shapes_tree is not None:
            spec = guard(spec, shapes_tree[name], mesh)
        out[name] = placements_for(spec, mesh)
    return out
