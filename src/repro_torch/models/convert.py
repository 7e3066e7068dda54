"""Carry the JAX package's parameters across into the port's model.

The reference keeps its parameters as a pytree of nested dicts, each
block-period position's leaves stacked along a leading ``num_periods``
axis (``stack/pos<j>/mixer/wq [P, d, Hq*hd]``). ``params_from_numpy``
takes that tree with numpy leaves (what ``jax.tree.map(np.asarray,
params)`` gives) and fills a ``Model`` whose layer ``i`` is period
``i // plen``, position ``i % plen``. Every leaf's shape is checked, and
a missing or an extra key raises.
"""
from __future__ import annotations

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


def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                      device: Optional[str] = None,
                      dtype: Optional[torch.dtype] = None) -> Model:
    """The port's model of ``cfg`` holding the reference's parameters
    ``tree``, on ``device`` (``None`` means CUDA and raises without one)
    in ``dtype`` (``None``: float32, the reference's default)."""
    leaves: Dict[Key, Any] = dict(_leaves(tree))
    model = Model(cfg, dtype or torch.float32, resolve_device(device))
    plen = len(cfg.block_pattern)
    periods = cfg.num_layers // plen
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = tuple(name.split("."))
            if parts[0] == "stack":          # stack.layers.<i>.<rest>
                i = int(parts[2])
                key = ("stack", f"pos{i % plen}") + parts[3:]
            else:
                key = parts
            if key not in leaves:
                raise KeyError(f"{cfg.name}: the tree has no "
                               f"{'/'.join(key)} for {name}")
            arr = np.asarray(leaves[key])
            if parts[0] == "stack":
                if arr.shape[:1] != (periods,):
                    raise ValueError(
                        f"{cfg.name}: {'/'.join(key)} has shape "
                        f"{arr.shape}, expected {periods} periods first")
                arr = arr[i // plen]
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
