"""The block and the layer stack (the PyTorch counterpart of
``repro.models.transformer``): attention, Mamba and RWKV blocks, with a
dense, MoE or RWKV channel-mix FFN, in any block pattern.

The reference stacks each block-period position's parameters along a
leading ``num_periods`` axis and scans over periods; here the stack is an
``nn.ModuleList`` of layers in the reference's layer order (layer ``i``
is period ``i // plen``, position ``i % plen``) and a loop over it. Its
sharding constraints (``sharding.rules.constrain`` on each branch
output, residual sum and normed input) redistribute a ``DTensor`` and
its gradient under active rules and are no-ops otherwise.
``remat`` wraps each block period in ``torch.utils.checkpoint`` as the
reference wraps its scan body in ``jax.checkpoint``: ``"full"`` recomputes
the period in the backward pass, ``"dots"`` saves the matmul outputs and
recomputes the rest, ``"none"`` saves everything. It changes memory,
never values.

The decode cache is a dict of tensors, one per state the block kinds of
the model keep, each stacked over the layers of that kind (``slot``):
``k``/``v [L_attn, B, S, Hkv, hd]``; ``conv [L_mamba, B, K-1, din]``
and ``ssm [L_mamba, B, din, N]`` (float32); ``shift_t``/``shift_c
[L_rwkv, B, 1, d]`` and ``wkv [L_rwkv, B, H, N, N]`` (float32). It is
preallocated once: prefill writes each layer's state and each decode
step updates it in place (the reference donates its cache to the jitted
step instead).
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ATTN, MAMBA, RWKV, ArchConfig
from ..sharding import rules
from ..sharding.rules import constrain
from .layers import FFN, Attention, empty_param, rms_norm
from .mamba import Mamba
from .moe import MoE
from .rwkv import ChannelMix, TimeMix

Cache = Dict[str, torch.Tensor]

MIXERS = {ATTN: Attention, MAMBA: Mamba, RWKV: TimeMix}

# "dots": the outputs of matmuls without batch dimensions are saved (the
# reference's checkpoint_dots_with_no_batch_dims); a projection of
# (B, S, d) activations reaches the dispatcher as a 2-D mm.
_save_dots = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def remat(policy: str, fn, *args):
    """``fn(*args)`` under the config's remat policy ("none", "dots" or
    "full"); a plain call where autograd records nothing."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_save_dots)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"unknown remat policy {policy!r}")


def act(x: torch.Tensor) -> torch.Tensor:
    """``x (B, S, d)`` constrained to the activations' layout."""
    return constrain(x, "batch", "seq", "act_embed")


def residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h``, constrained. Under a mesh the branch ``h`` is reduced
    before the add, as GSPMD reduces a contraction's partial sum at the
    dot that forms it: DTensor would add the residual into one rank's
    share and reduce later, rounding apart from the reference."""
    return act(x + act(h))


def normed(scale: torch.Tensor, x: torch.Tensor, eps: float
           ) -> torch.Tensor:
    """``rms_norm(scale, x)``, constrained: in the backward the
    constraint reduces the branch's input gradient (a partial sum over
    the model axis, from the projections' transposed dots) before the
    norm's backward, where GSPMD reduces it, rather than wherever
    DTensor's cost model would."""
    return act(rms_norm(scale, x, eps))


class Block(nn.Module):
    """Pre-norm residual block: ``x + mixer(norm1(x))``, then
    ``x + ffn(norm2(x))``. The mixer is attention, Mamba or RWKV
    time-mix; the FFN is RWKV's channel-mix in an RWKV block, else a
    dense SwiGLU or MoE. ``slot`` is the block's index among the layers
    of its kind, its place in the stacked decode cache."""

    def __init__(self, cfg: ArchConfig, kind: str, is_moe: bool, slot: int,
                 dtype: torch.dtype, device: torch.device,
                 causal: bool = True) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.kind = kind
        self.is_moe = is_moe
        self.slot = slot
        self.norm1 = empty_param(cfg.d_model, dtype=dtype, device=device)
        if kind == ATTN:
            self.mixer = Attention(cfg, dtype, device, causal=causal)
        else:
            self.mixer = MIXERS[kind](cfg, dtype, device)
        self.norm2 = empty_param(cfg.d_model, dtype=dtype, device=device)
        if kind == RWKV:
            self.ffn = ChannelMix(cfg, dtype, device)
        elif is_moe:
            self.ffn = MoE(cfg, dtype, device)
        else:
            self.ffn = FFN(cfg, dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Full-sequence block. Returns ``(x, moe_aux)``, the aux loss
        ``None`` without an MoE FFN. With ``cache`` (prefill) it also
        writes this layer's decode state into its slot."""
        h, state = self.mixer(normed(self.norm1, x, self.eps), positions)
        x = residual(x, h)
        h = normed(self.norm2, x, self.eps)
        if cache is not None:
            # attention fills the first S positions of its max_seq; every
            # other state fills its slot whole
            for name, value in zip(self.mixer.STATE, state, strict=True):
                cache[name][self.slot, :, :value.shape[1]] = value
            if self.kind == RWKV:
                cache["shift_c"][self.slot] = h[:, -1:]
        if self.is_moe:
            h, aux = self.ffn(h)
            return residual(x, h), aux
        return residual(x, self.ffn(h)), None

    def decode(self, x: torch.Tensor, cache: Cache, pos: int
               ) -> torch.Tensor:
        """One-token decode, x (B,1,d), reading and updating this layer's
        state in ``cache`` in place."""
        state = tuple(cache[name][self.slot] for name in self.mixer.STATE)
        x = x + self.mixer.decode(rms_norm(self.norm1, x, self.eps), state,
                                  pos)
        h = rms_norm(self.norm2, x, self.eps)
        if self.kind == RWKV:
            shift = cache["shift_c"][self.slot]
            out = self.ffn(h, shift_state=shift)
            shift.copy_(h)  # this token's pre-mix input is the next shift
            return x + out
        if self.is_moe:
            return x + self.ffn(h)[0]
        return x + self.ffn(h)


def state_shapes(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                 dtype: torch.dtype):
    """``{name: (shape, dtype)}`` of one layer's decode state."""
    d = cfg.d_model
    if kind == ATTN:
        shape = (batch, max_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        return {"k": (shape, dtype), "v": (shape, dtype)}
    if kind == MAMBA:
        din = cfg.ssm_expand * d
        return {"conv": ((batch, cfg.ssm_conv_dim - 1, din), dtype),
                "ssm": ((batch, din, cfg.ssm_state_dim), torch.float32)}
    if kind == RWKV:
        n = cfg.rwkv_head_dim
        return {"shift_t": ((batch, 1, d), dtype),
                "shift_c": ((batch, 1, d), dtype),
                "wkv": ((batch, d // n, n, n), torch.float32)}
    raise ValueError(kind)


# Each decode-cache tensor's logical axes, its leading dimension the
# layers of its block kind (the reference's init_block_cache under
# "layers").
CACHE_AXES = {
    ATTN: {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
           "v": ("layers", "batch", "kv_seq", "kv_heads", None)},
    MAMBA: {"conv": ("layers", "batch", None, "ssm_inner"),
            "ssm": ("layers", "batch", "ssm_inner", None)},
    RWKV: {"shift_t": ("layers", "batch", None, "embed"),
           "shift_c": ("layers", "batch", None, "embed"),
           "wkv": ("layers", "batch", "heads", None, None)},
}


class Stack(nn.Module):
    """``num_layers`` blocks of ``cfg.layer_kinds()``, MoE where
    ``cfg.is_moe_layer(i)``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        plen = len(cfg.block_pattern)
        if cfg.num_layers % plen != 0:
            raise ValueError(
                f"{cfg.name}: num_layers {cfg.num_layers} not divisible by "
                f"block pattern period {plen}")
        self.cfg = cfg
        self.plen = plen
        slots = Counter()
        layers = []
        for i, kind in enumerate(cfg.layer_kinds()):
            layers.append(Block(cfg, kind, cfg.is_moe_layer(i), slots[kind],
                                dtype, device))
            slots[kind] += 1
        self.layers = nn.ModuleList(layers)
        self.kinds = dict(slots)

    def _period(self, lo: int, x: torch.Tensor, positions: torch.Tensor):
        aux_total = torch.zeros((), device=x.device)
        for block in self.layers[lo:lo + self.plen]:
            x, aux = block(x, positions)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Full-sequence stack, each block period under ``cfg.remat``.
        Returns ``(x, total_moe_aux)``."""
        aux_sum = torch.zeros((), device=x.device)
        for lo in range(0, len(self.layers), self.plen):
            x, aux = remat(self.cfg.remat, self._period, lo, x, positions)
            aux_sum = aux_sum + aux
        return x, aux_sum

    def init_cache(self, batch: int, max_seq: int, dtype: torch.dtype,
                   device: torch.device) -> Cache:
        """Zeroed decode state of every layer, stacked per kind (under
        active sharding rules, sharded by ``CACHE_AXES``)."""
        cache: Cache = {}
        for kind, count in self.kinds.items():
            for name, (shape, dt) in state_shapes(self.cfg, kind, batch,
                                                  max_seq, dtype).items():
                cache[name] = rules.zeros((count,) + shape,
                                          *CACHE_AXES[kind][name],
                                          dtype=dt, device=device)
        return cache

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Cache) -> torch.Tensor:
        """Full-sequence stack that also writes every layer's decode
        state into ``cache``."""
        for block in self.layers:
            x, _ = block(x, positions, cache)
        return x

    def decode(self, x: torch.Tensor, cache: Cache, pos: int) -> torch.Tensor:
        for block in self.layers:
            x = block.decode(x, cache, pos)
        return x
