"""Carry parameters between the JAX package's pytree and the port's model.

The reference keeps its parameters as a pytree of nested dicts, each
block-period position's leaves stacked along a leading ``num_periods``
axis (``stack/pos<j>/mixer/wq [P, d, Hq*hd]``), the encoder's blocks
along ``encoder_layers`` (``encoder/blocks/...``) and the per-layer
cross-attention along ``num_layers`` (``cross/attn/wq``, ``cross/norm``).
The port's model has one module per layer: layer ``i`` of the stack is
period ``i // plen``, position ``i % plen``.

``params_from_numpy`` takes that tree with numpy leaves (what
``jax.tree.map(np.asarray, params)`` gives) and fills a ``Model``; every
leaf's shape is checked, and a missing or an extra key raises.
``params_to_numpy`` is its inverse: the model's parameters, or any
tensors keyed by the model's parameter names (their gradients, AdamW's
moments), as the reference's tree.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..kernels.ops import resolve_device
from .model import Model

Key = Tuple[str, ...]


def _leaves(tree: Mapping[str, Any], prefix: Key = ()
            ) -> Iterator[Tuple[Key, Any]]:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def tree_key(cfg: ArchConfig, name: str) -> Tuple[Key, Optional[int], int]:
    """Where the port's parameter ``name`` lives in the reference's tree:
    ``(key, index, count)``, the leaf being stacked ``count`` deep and
    this parameter its row ``index`` (``None``: not stacked)."""
    parts = tuple(name.split("."))
    plen = len(cfg.block_pattern)
    if parts[0] == "stack":                  # stack.layers.<i>.<rest>
        i = int(parts[2])
        return (("stack", f"pos{i % plen}") + parts[3:], i // plen,
                cfg.num_layers // plen)
    if parts[:2] == ("encoder", "blocks"):   # encoder.blocks.<i>.<rest>
        return (("encoder", "blocks") + parts[3:], int(parts[2]),
                cfg.encoder_layers)
    if parts[0] == "cross":                  # cross.<i>.<rest>
        return ("cross",) + parts[2:], int(parts[1]), cfg.num_layers
    return parts, None, 0


def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                      device: Optional[str] = None,
                      dtype: Optional[torch.dtype] = None) -> Model:
    """The port's model of ``cfg`` holding the reference's parameters
    ``tree``, on ``device`` (``None`` means CUDA and raises without one)
    in ``dtype`` (``None``: float32, the reference's default)."""
    leaves: Dict[Key, Any] = dict(_leaves(tree))
    model = Model(cfg, dtype or torch.float32, resolve_device(device))
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            key, index, count = tree_key(cfg, name)
            if key not in leaves:
                raise KeyError(f"{cfg.name}: the tree has no "
                               f"{'/'.join(key)} for {name}")
            arr = np.asarray(leaves[key])
            if index is not None:
                if arr.shape[:1] != (count,):
                    raise ValueError(
                        f"{cfg.name}: {'/'.join(key)} has shape "
                        f"{arr.shape}, expected {count} stacked first")
                arr = arr[index]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{cfg.name}: {'/'.join(key)} has shape "
                                 f"{arr.shape}, {name} needs "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))  # a writable copy
            used.add(key)
    extra = sorted("/".join(k) for k in set(leaves) - used)
    if extra:
        raise KeyError(f"{cfg.name}: keys the model does not have: {extra}")
    return model.eval()


def params_to_numpy(model: Model,
                    tensors: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Dict[str, Any]:
    """The reference's tree of numpy arrays holding ``tensors`` (keyed by
    the model's parameter names; default: the parameters themselves),
    the stacked leaves stacked again in layer order."""
    cfg = model.cfg
    if tensors is None:
        tensors = dict(model.named_parameters())
    rows: Dict[Key, Dict[int, np.ndarray]] = defaultdict(dict)
    tree: Dict[str, Any] = {}
    for name, _ in model.named_parameters():
        arr = tensors[name].detach().cpu().numpy()
        key, index, count = tree_key(cfg, name)
        if index is None:
            value = arr
        else:
            rows[key][index] = arr
            if len(rows[key]) < count:
                continue
            value = np.stack([rows[key][i] for i in range(count)])
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = value
    return tree
