"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch
(the PyTorch counterpart of ``repro.models.moe``).

Two dispatch families, chosen by ``cfg.moe_dispatch``, each computing
what the reference's does, token drops included:

* ``"einsum"`` (default): GShard one-hot dispatch/combine einsums with a
  capacity per routing group of ``GROUP_SIZE`` tokens and a cumsum
  position in each expert's queue (tokens in group order win);
* ``"gather"``: a stable sort by expert, a scatter-add into capacity
  slots and a gather back (tokens in sorted order win).

At a capacity factor below ``num_experts / experts_per_token`` the two
drop different tokens by design, so they agree only where nothing drops.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.nn import functional as F

from ..configs.base import ArchConfig
from ..sharding.rules import local_inputs
from .layers import empty_param

# Tokens per routing group of the einsum dispatch: capacity (and the
# one-hot grid) is per group, so dispatch cost is O(T * E * C_g) with
# C_g = O(GROUP_SIZE) rather than O(T^2).
GROUP_SIZE = 1024


class MoE(nn.Module):
    """``router [d, E]``; experts ``w_gate``/``w_up [E, d, F]``,
    ``w_down [E, F, d]``. ``forward`` returns ``(out, aux)`` with the
    Switch load-balancing loss in float32 (``moe_ffn_with_aux``).

    On a ``DTensor`` (a mesh with the experts sharded over its model
    axis) each rank runs its own tokens through its own experts inside
    ``local_map``: the routing is computed on every rank alike, the
    output is a partial sum over the model axis, and the aux loss's two
    per-expert means come back as partial sums over the ranks, so that
    the loss and every gradient equal the unsharded model's."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
        self.cfg = cfg
        self.router = empty_param(d, e, dtype=dtype, device=device)
        self.w_gate = empty_param(e, d, f, dtype=dtype, device=device)
        self.w_up = empty_param(e, d, f, dtype=dtype, device=device)
        self.w_down = empty_param(e, f, d, dtype=dtype, device=device)

    def _dispatch(self):
        return (moe_ffn_gather if self.cfg.moe_dispatch == "gather"
                else moe_ffn_einsum)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        weights = (self.router, self.w_gate, self.w_up, self.w_down)
        if isinstance(x, DTensor):
            out, tpe, ppe = _sharded(self._dispatch(), self.cfg, x, weights)
        else:
            out, tpe, ppe = self._dispatch()(x, *weights, self.cfg)
        aux = self.cfg.moe.num_experts * torch.sum(tpe * ppe)
        return out, aux.float()


def _sharded(fn, cfg: ArchConfig, x: DTensor, weights):
    """``fn`` on each rank's tokens and experts (see ``MoE``)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    mi = names.index("model")
    w_pl = tuple(weights[1].placements)
    experts_sharded = w_pl[mi].is_shard(0)
    # each rank's token rows (batch-sharded or whole), every feature
    xp = [p if p.is_shard(0) else Replicate() for p in x.placements]
    xp[mi] = Replicate()
    out_pl = list(xp)
    x_grad = list(xp)
    if experts_sharded:
        out_pl[mi] = x_grad[mi] = Partial()
    # the aux loss's per-expert means: partial sums over every dim whose
    # ranks hold other tokens or other experts (each rank's share
    # divided by their number)
    mean_pl = [Partial() if i != mi or experts_sharded else Replicate()
               for i in range(mesh.ndim)]
    share = 1
    for i, p in enumerate(mean_pl):
        if p.is_partial():
            share *= mesh.size(i)
    e_pl = [Replicate()] * mesh.ndim
    e_pl[mi] = w_pl[mi]
    e_grad = [Partial()] * mesh.ndim
    e_grad[mi] = w_pl[mi]
    r_pl = [Replicate()] * mesh.ndim

    def local(x, router, w_gate, w_up, w_down):
        e0 = (mesh.get_local_rank("model") * w_gate.shape[0]
              if experts_sharded else 0)
        out, tpe, ppe = fn(x, router, w_gate, w_up, w_down, cfg, e0)
        return out, tpe / share, ppe / share

    return local_map(
        local_inputs(local), out_placements=(out_pl, mean_pl, mean_pl),
        in_placements=(xp, r_pl, e_pl, e_pl, e_pl),
        in_grad_placements=(x_grad, [Partial()] * mesh.ndim, e_grad,
                            e_grad, e_grad),
        device_mesh=mesh, redistribute_inputs=True)(x, *weights)


def _route(router: torch.Tensor, xt: torch.Tensor, k: int):
    """Router softmax in float32 and its top-k, renormalised.

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` promises no order on ties, so the top k come from a
    stable descending sort, which keeps the lower index first."""
    probs = F.softmax((xt @ router).float(), dim=-1)
    topk_p, topk_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_i = topk_p[..., :k], topk_i[..., :k]
    topk_p = topk_p / torch.clamp(topk_p.sum(dim=-1, keepdim=True),
                                  min=1e-9)
    return probs, topk_p, topk_i


def _experts(w_gate, w_up, w_down, xin: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: xin (..., E, C, d) -> (..., E, C, d)."""
    h_gate = F.silu(torch.einsum("...ecd,edf->...ecf", xin, w_gate))
    h_up = torch.einsum("...ecd,edf->...ecf", xin, w_up)
    return torch.einsum("...ecf,efd->...ecd", h_gate * h_up, w_down)


def moe_ffn_gather(x: torch.Tensor, router, w_gate, w_up, w_down,
                   cfg: ArchConfig, e0: int = 0):
    """Sort/gather dispatch: no dispatch FLOPs, only the expert matmuls.
    Over-capacity (token, choice) pairs drop in sorted order. The
    experts given are ``e0 .. e0 + len(w_gate)`` of the config's; the
    output sums theirs. Returns ``(out, tokens_per_expert,
    prob_per_expert)``, the aux loss's two means."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.experts_per_token
    t = b * s
    xt = x.reshape(t, d)

    probs, topk_p, topk_i = _route(router, xt, k)
    onehot_mean = F.one_hot(topk_i, e).float().sum(1).mean(0)

    capacity = max(int(m.capacity_factor * t * k / e), 1)

    flat_e = topk_i.reshape(t * k)
    flat_gate = topk_p.reshape(t * k)
    flat_tok = torch.arange(t * k, device=x.device) // k
    order = torch.argsort(flat_e, stable=True)        # group by expert
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(e, device=x.device))
    pos = torch.arange(t * k, device=x.device) - seg_start[sorted_e]
    keep = pos < capacity
    slot = torch.where(keep, sorted_e * capacity + pos,
                       torch.full_like(pos, e * capacity))

    tok = flat_tok[order]

    # dispatch: scatter tokens into (E*C, d) slots, the last a sink for
    # the dropped ones
    src = xt[tok] * keep[:, None].to(x.dtype)
    xin = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    xin.index_add_(0, slot, src)
    el = w_gate.shape[0]
    lo, hi = e0 * capacity, (e0 + el) * capacity
    h = _experts(w_gate, w_up, w_down, xin[lo:hi].reshape(el, capacity, d))
    h = h.reshape(el * capacity, d)

    # combine: gather the given experts' outputs back to tokens, weighted
    held = keep & (slot >= lo) & (slot < hi)
    gathered = h[torch.clamp(slot - lo, min=0, max=el * capacity - 1)]
    gathered = gathered * (flat_gate[order] * held)[:, None].to(x.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, tok, gathered)
    return out.reshape(b, s, d), onehot_mean, probs.mean(0)


def moe_ffn_einsum(x: torch.Tensor, router, w_gate, w_up, w_down,
                   cfg: ArchConfig, e0: int = 0):
    """GShard one-hot dispatch with a capacity per routing group. The
    experts given and the return as ``moe_ffn_gather``'s."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.experts_per_token
    t = b * s
    tg = GROUP_SIZE if t % GROUP_SIZE == 0 else t
    g = t // tg
    xt = x.reshape(g, tg, d)

    probs, topk_p, topk_i = _route(router, xt, k)       # (G, Tg, k)

    # load-balancing auxiliary loss (Switch): e * sum(frac_tokens * frac_p)
    onehot = F.one_hot(topk_i, e).float()                # (G, Tg, k, E)
    tokens_per_expert = onehot.sum(2).mean((0, 1))
    prob_per_expert = probs.mean((0, 1))

    capacity = max(int(m.capacity_factor * tg * k / e), 1)

    # position of each (token, choice) in its expert's per-group queue
    flat_onehot = onehot.reshape(g, tg * k, e)
    pos_in_expert = torch.cumsum(flat_onehot, dim=1) - 1.0
    pos_in_expert = (pos_in_expert * flat_onehot).sum(-1)
    keep = (pos_in_expert < capacity).reshape(g, tg, k)
    pos_in_expert = pos_in_expert.reshape(g, tg, k)

    gate = (topk_p * keep).float()                       # (G, Tg, k)
    cap_oh = F.one_hot(
        torch.where(keep, pos_in_expert,
                    torch.full_like(pos_in_expert, capacity)).long(),
        capacity + 1)[..., :capacity].float()            # (G, Tg, k, C)
    # dispatch/combine tensors (G, Tg, E, C)
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot * keep[..., None],
                            cap_oh)
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gate, onehot, cap_oh)
    el = w_gate.shape[0]
    if el < e:                               # this rank's experts only
        dispatch = dispatch[:, :, e0:e0 + el]
        combine = combine[:, :, e0:e0 + el]

    xin = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xt)
    h = _experts(w_gate, w_up, w_down, xin)
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), h)
    return out.reshape(b, s, d), tokens_per_expert, prob_per_expert
