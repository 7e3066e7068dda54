"""Logical axes of the port's parameters and decode caches.

The reference returns a logical-axes pytree beside its parameters from
``init`` (``repro.models.layers.init_*``): a tuple of logical names per
leaf, with ``"layers"`` prepended to every leaf stacked over layers.
The port's ``nn.Module``s own their tensors, one module per layer, so
here the same tables are keyed by the module class that owns a
parameter. ``param_axes`` gives each ``named_parameters()`` name the
axes of the port's (per-layer) tensor; ``axes_tree`` lays them out as
the reference's tree through ``convert.tree_key``, so the two compare
leaf for leaf. ``cache_axes`` gives each tensor of the port's decode
cache (stacked per block kind over that kind's layers) its axes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from torch import nn

from ..configs.base import ArchConfig
from .convert import tree_key
from .transformer import CACHE_AXES

Axes = Tuple[Optional[str], ...]

# Per owning module class, each parameter's logical axes (the reference's
# init_attention, init_ffn, init_moe, init_mamba, init_time_mix,
# init_channel_mix, init_embeddings and the norm scales).
MODULE_AXES: Dict[str, Dict[str, Axes]] = {
    "Embeddings": {"tok": ("vocab", "embed"), "out": ("embed", "vocab")},
    "Attention": {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
                  "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
                  "bq": ("heads",), "bk": ("kv_heads",),
                  "bv": ("kv_heads",)},
    "FFN": {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
            "w_down": ("ff", "embed")},
    "MoE": {"router": ("embed", "experts_r"),
            "w_gate": ("experts", "embed", "ff_expert"),
            "w_up": ("experts", "embed", "ff_expert"),
            "w_down": ("experts", "ff_expert", "embed")},
    "Mamba": {"in_proj": ("embed", "ssm_inner"),
              "conv_w": (None, "ssm_inner"), "conv_b": ("ssm_inner",),
              "x_proj": ("ssm_inner", None),
              "dt_proj": (None, "ssm_inner"), "dt_bias": ("ssm_inner",),
              "a_log": ("ssm_inner", None), "d_skip": ("ssm_inner",),
              "out_proj": ("ssm_inner", "embed")},
    "TimeMix": {"mu": (None, "embed"), "w_r": ("embed", "heads"),
                "w_k": ("embed", "heads"), "w_v": ("embed", "heads"),
                "w_g": ("embed", "heads"), "w_o": ("heads", "embed"),
                "w0": ("heads",), "w_lora_a": ("embed", None),
                "w_lora_b": (None, "heads"), "u": ("heads",),
                "ln_scale": ("heads",)},
    "ChannelMix": {"mu": (None, "embed"), "w_k": ("embed", "ff"),
                   "w_v": ("ff", "embed"), "w_r": ("embed", "heads")},
    # norm scales
    "Block": {"norm1": ("embed",), "norm2": ("embed",)},
    "Model": {"norm_f": ("embed",)},
    "Encoder": {"norm_f": ("embed",)},
    "CrossBlock": {"norm": ("embed",)},
}

def param_axes(model: nn.Module) -> Dict[str, Axes]:
    """``{parameter name: logical axes of the port's tensor}``."""
    out = {}
    for prefix, module in model.named_modules():
        table = MODULE_AXES.get(type(module).__name__, {})
        for leaf, _ in module.named_parameters(recurse=False):
            if leaf not in table:
                raise KeyError(f"{type(module).__name__}.{leaf} has no "
                               "logical axes")
            out[f"{prefix}.{leaf}" if prefix else leaf] = table[leaf]
    return out


def axes_tree(model: nn.Module) -> Dict[str, Any]:
    """The reference's axes pytree of ``model``: nested dicts keyed as
    ``convert.tree_key`` keys the parameters, ``"layers"`` prepended to
    every stacked leaf."""
    tree: Dict[str, Any] = {}
    for name, axes in param_axes(model).items():
        key, index, _ = tree_key(model.cfg, name)
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = axes if index is None else ("layers",) + axes
    return tree


def cache_axes(cfg: ArchConfig) -> Dict[str, Axes]:
    """``{cache tensor name: logical axes}`` for ``cfg``'s block kinds."""
    out: Dict[str, Axes] = {}
    for kind in dict.fromkeys(cfg.layer_kinds()):
        out.update(CACHE_AXES[kind])
    return out
