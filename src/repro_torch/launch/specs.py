"""DTensor stand-ins for every (arch x shape) cell's inputs (the
PyTorch counterpart of ``repro.launch.specs``).

The reference builds sharded ``ShapeDtypeStruct``s and lowers its steps
against them. Here each input is a ``DTensor`` whose local tensor is
rank 0's shard, made with ``torch.empty`` on the mesh's device type:
under a ``FakeTensorMode`` (the dry-run) nothing is allocated, outside
one it is a real shard to fill (a run of rank 0 on the card). Placements
come from the logical axes through ``sharding.rules`` with the same
divisibility guard as ``constrain`` (e.g. global_batch=1 decode cannot
shard batch over ``data``).

Parameters: the model is built on the ``meta`` device (no memory at any
width), ``param_specs`` makes a stand-in per ``named_parameters()`` name
from its shape and the axes of ``models.axes``, and ``shard_model``
puts them into the model in place of its parameters.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig, ShapeSpec
from ..models.axes import cache_axes, param_axes
from ..models.model import Model
from ..models.transformer import state_shapes
from ..sharding.rules import (guard, param_shardings, placements_for,
                              spec_for)
from ..train.optimizer import AdamWState

# [audio]/[vlm] frontend stub: precomputed frame/patch embeddings length.
ENC_FRAMES = 1024


def _strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def _stand_in(shape, dtype, mesh, placements) -> DTensor:
    """A DTensor of global ``shape`` with ``placements`` (each sharded
    dimension divisible), its local tensor rank 0's uninitialised
    shard."""
    local_shape = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local_shape[p.dim] //= mesh.size(i)
    local = torch.empty(local_shape, dtype=dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_strides(shape))


def _sds(shape, dtype, mesh, rules, axes) -> DTensor:
    """Sharded stand-in with the same divisibility guard as constrain."""
    spec = guard(spec_for(axes, rules), shape, mesh)
    return _stand_in(tuple(shape), dtype, mesh, placements_for(spec, mesh))


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                rules: Dict) -> Dict[str, DTensor]:
    b, s = shape.global_batch, shape.seq_len
    toks = _sds((b, s), torch.int32, mesh, rules, ("batch", "seq"))
    out = {"tokens": toks, "targets": toks}
    if cfg.encoder_layers:
        out["enc_input"] = _sds((b, ENC_FRAMES, cfg.d_model), torch.float32,
                                mesh, rules, ("batch", None, "act_embed"))
    return out


def param_specs(model: Model, mesh, rules: Dict
                ) -> Tuple[Dict[str, DTensor], Dict[str, tuple]]:
    """(``{name: sharded parameter stand-in}``, ``{name: axes}``)."""
    axes = param_axes(model)
    params = dict(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    shardings = param_shardings(axes, mesh, rules, shapes)
    specs = {n: _stand_in(shapes[n], p.dtype, mesh, shardings[n])
             for n, p in params.items()}
    return specs, axes


def shard_model(model: nn.Module, specs: Mapping[str, DTensor]) -> None:
    """Replace each parameter of ``model`` by its stand-in (frozen, as
    ``build_model`` leaves a model; the train steps turn gradients
    on)."""
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        mod._parameters[leaf] = nn.Parameter(spec, requires_grad=False)


def zero_extend_axes(axes_tree: Mapping[str, tuple]) -> Dict[str, tuple]:
    """Replace each leaf's first replicated ('embed'/None) dim with the
    'zero' logical axis (ZeRO optimizer-state sharding over data)."""
    out = {}
    for name, axes in axes_tree.items():
        ax = list(axes)
        for i, a in enumerate(ax):
            if a is None or a == "embed":
                ax[i] = "zero"
                break
        out[name] = tuple(ax)
    return out


def opt_state_specs(param_spec_tree: Mapping[str, DTensor], mesh,
                    axes_tree=None, rules=None) -> AdamWState:
    """AdamW state mirrors params (fp32 moments). With ``axes_tree`` +
    ``rules`` the moments are additionally ZeRO-sharded over data; the
    step counter is replicated."""
    shapes = {n: tuple(s.shape) for n, s in param_spec_tree.items()}
    if axes_tree is not None and rules is not None:
        shardings = param_shardings(zero_extend_axes(axes_tree), mesh,
                                    rules, shapes)
    else:
        shardings = {n: tuple(s.placements)
                     for n, s in param_spec_tree.items()}

    def moments():
        return {n: _stand_in(shapes[n], torch.float32, mesh, shardings[n])
                for n in param_spec_tree}

    return AdamWState(
        step=_stand_in((), torch.int32, mesh, placements_for((), mesh)),
        mu=moments(), nu=moments())


def cache_specs(model: Model, shape: ShapeSpec, mesh,
                rules: Dict) -> Dict[str, DTensor]:
    """Decode-cache stand-ins (a KV cache of seq_len, the layers of each
    block kind stacked), as ``Model.init_cache`` lays them out."""
    cfg = model.cfg
    axes = cache_axes(cfg)
    out = {}
    for kind, count in model.stack.kinds.items():
        for name, (shp, dt) in state_shapes(
                cfg, kind, shape.global_batch, shape.seq_len,
                model.norm_f.dtype).items():
            out[name] = _sds((count,) + shp, dt, mesh, rules, axes[name])
    return out


def serve_input_specs(model: Model, shape: ShapeSpec, mesh,
                      rules: Dict) -> Tuple:
    """(cache, token, pos[, enc_out]) for the serve step; ``pos`` is the
    cache's last position (every position attended)."""
    cfg = model.cfg
    b = shape.global_batch
    cache = cache_specs(model, shape, mesh, rules)
    token = _sds((b, 1), torch.int32, mesh, rules, ("batch", None))
    pos = shape.seq_len - 1
    if cfg.encoder_layers:
        # enc_out is the encoder's output: model compute dtype
        enc_out = _sds((b, ENC_FRAMES, cfg.d_model), model.norm_f.dtype,
                       mesh, rules, ("batch", None, "act_embed"))
        return cache, token, pos, enc_out
    return cache, token, pos


def prefill_input_specs(model: Model, shape: ShapeSpec, mesh,
                        rules: Dict) -> Tuple:
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    tokens = _sds((b, s), torch.int32, mesh, rules, ("batch", "seq"))
    if cfg.encoder_layers:
        enc_input = _sds((b, ENC_FRAMES, cfg.d_model), torch.float32, mesh,
                         rules, ("batch", None, "act_embed"))
        return tokens, enc_input
    return (tokens,)
