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
from torch.nn import functional as F

from ..configs.base import ArchConfig
from .layers import empty_param

# Tokens per routing group of the einsum dispatch: capacity (and the
# one-hot grid) is per group, so dispatch cost is O(T * E * C_g) with
# C_g = O(GROUP_SIZE) rather than O(T^2).
GROUP_SIZE = 1024


class MoE(nn.Module):
    """``router [d, E]``; experts ``w_gate``/``w_up [E, d, F]``,
    ``w_down [E, F, d]``. ``forward`` returns ``(out, aux)`` with the
    Switch load-balancing loss in float32 (``moe_ffn_with_aux``)."""

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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.cfg.moe_dispatch == "gather":
            return moe_ffn_gather(self, x, self.cfg)
        return moe_ffn_einsum(self, x, self.cfg)


def _route(moe: MoE, xt: torch.Tensor, k: int):
    """Router softmax in float32 and its top-k, renormalised.

    ``jax.lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` promises no order on ties, so the top k come from a
    stable descending sort, which keeps the lower index first."""
    probs = F.softmax((xt @ moe.router).float(), dim=-1)
    topk_p, topk_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_i = topk_p[..., :k], topk_i[..., :k]
    topk_p = topk_p / torch.clamp(topk_p.sum(dim=-1, keepdim=True),
                                  min=1e-9)
    return probs, topk_p, topk_i


def _experts(moe: MoE, xin: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert: xin (..., E, C, d) -> (..., E, C, d)."""
    h_gate = F.silu(torch.einsum("...ecd,edf->...ecf", xin, moe.w_gate))
    h_up = torch.einsum("...ecd,edf->...ecf", xin, moe.w_up)
    return torch.einsum("...ecf,efd->...ecd", h_gate * h_up, moe.w_down)


def moe_ffn_gather(moe: MoE, x: torch.Tensor,
                   cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort/gather dispatch: no dispatch FLOPs, only the expert matmuls.
    Over-capacity (token, choice) pairs drop in sorted order."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.experts_per_token
    t = b * s
    xt = x.reshape(t, d)

    probs, topk_p, topk_i = _route(moe, xt, k)
    onehot_mean = F.one_hot(topk_i, e).float().sum(1).mean(0)
    aux = e * torch.sum(onehot_mean * probs.mean(0))

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
    h = _experts(moe, xin[:-1].reshape(e, capacity, d))
    h = h.reshape(e * capacity, d)

    # combine: gather expert outputs back to tokens, weighted
    gathered = h[torch.clamp(slot, max=e * capacity - 1)]
    gathered = gathered * (flat_gate[order] * keep)[:, None].to(x.dtype)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, tok, gathered)
    return out.reshape(b, s, d), aux.float()


def moe_ffn_einsum(moe: MoE, x: torch.Tensor,
                   cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot dispatch with a capacity per routing group."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.experts_per_token
    t = b * s
    tg = GROUP_SIZE if t % GROUP_SIZE == 0 else t
    g = t // tg
    xt = x.reshape(g, tg, d)

    probs, topk_p, topk_i = _route(moe, xt, k)          # (G, Tg, k)

    # load-balancing auxiliary loss (Switch): e * sum(frac_tokens * frac_p)
    onehot = F.one_hot(topk_i, e).float()                # (G, Tg, k, E)
    tokens_per_expert = onehot.sum(2).mean((0, 1))
    prob_per_expert = probs.mean((0, 1))
    aux = e * torch.sum(tokens_per_expert * prob_per_expert)

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

    xin = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xt)
    h = _experts(moe, xin)
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), h)
    return out.reshape(b, s, d), aux.float()
