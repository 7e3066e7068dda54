"""Gradient compression: int8 quantized cross-replica reduction with
error feedback (the PyTorch counterpart of
``repro.train.grad_compress``).

Scheme, per leaf:

  1. agree on a scale: the MAX of |g| over the replicas (one scalar);
  2. quantize to int8 with round-to-nearest (ties to even), carrying the
     quantization error into the next step (error feedback, which keeps
     the scheme unbiased over time);
  3. all-reduce the int8 values, summed in int32 to avoid overflow
     across replicas;
  4. dequantize with scale / replica count.

``compressed_psum_tree`` runs steps 1 and 3 as ``torch.distributed``
all-reduces (MAX, then SUM) over the process group passed in, where the
reference runs ``pmax``/``psum`` over a ``shard_map`` axis.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import distributed as dist

from . import tree as T

Q_MAX = 127.0


def quantize(g: torch.Tensor, scale: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    if scale is None:
        scale = g32.abs().max() / Q_MAX + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -Q_MAX, Q_MAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_with_feedback(g: torch.Tensor, error: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(quantized, scale, new_error). ``error`` is the residual carried
    from the previous step (same shape as g, float32)."""
    g32 = g.float() + error
    q, scale = quantize(g32)
    return q, scale, g32 - dequantize(q, scale)


def init_error_state(params: Any) -> Any:
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def compressed_psum_tree(grads: Any, error_state: Any,
                         group: Optional[dist.ProcessGroup] = None
                         ) -> Tuple[Any, Any]:
    """int8 compressed all-reduce (mean) over the replicas of ``group``
    (default: the world). Returns (reduced grads float32, new error
    state)."""
    n = dist.get_world_size(group)

    def one(g, err):
        g32 = g.float() + err
        scale = g32.abs().max()
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        scale = scale / Q_MAX + 1e-12
        q = torch.clamp(torch.round(g32 / scale), -Q_MAX,
                        Q_MAX).to(torch.int8)
        new_err = g32 - q.float() * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.float() * scale / n, new_err

    pairs = [one(g, e) for g, e in zip(T.leaves(grads),
                                       T.leaves(error_state), strict=True)]
    return (T.unflatten(grads, iter(p[0] for p in pairs)),
            T.unflatten(grads, iter(p[1] for p in pairs)))
