"""The decoder block and the layer stack (the PyTorch counterpart of
``repro.models.transformer``), for attention blocks with a dense or MoE
FFN.

The reference stacks each block-period position's parameters along a
leading ``num_periods`` axis and scans over periods; here the stack is an
``nn.ModuleList`` of layers in the reference's layer order (layer ``i``
is period ``i // plen``, position ``i % plen``) and a loop over it. The
reference's ``remat`` only matters to training, and its sharding
constraints are no-ops on one device; neither appears here.

The decode cache is ``{"k": [L, B, S, Hkv, hd], "v": ...}``, preallocated
once: prefill writes a layer's K/V into ``[:, :S_prompt]`` and each
decode step writes one position in place (the reference donates its
cache to the jitted step instead).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from .layers import FFN, Attention, empty_param, rms_norm
from .moe import MoE

Cache = Dict[str, torch.Tensor]


class Block(nn.Module):
    """Pre-norm residual block: ``x + attn(norm1(x))``, then
    ``x + ffn(norm2(x))`` with a dense SwiGLU or MoE FFN."""

    def __init__(self, cfg: ArchConfig, is_moe: bool, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.is_moe = is_moe
        self.norm1 = empty_param(cfg.d_model, dtype=dtype, device=device)
        self.mixer = Attention(cfg, dtype, device)
        self.norm2 = empty_param(cfg.d_model, dtype=dtype, device=device)
        self.ffn = (MoE(cfg, dtype, device) if is_moe
                    else FFN(cfg, dtype, device))

    def _ffn(self, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        h = rms_norm(self.norm2, x, self.eps)
        if self.is_moe:
            h, aux = self.ffn(h)
            return x + h, aux
        return x + self.ffn(h), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Full-sequence block. Returns ``(x, moe_aux, k, v)``, the aux
        loss ``None`` for a dense FFN."""
        h, k, v = self.mixer(rms_norm(self.norm1, x, self.eps), positions)
        x, aux = self._ffn(x + h)
        return x, aux, k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int) -> torch.Tensor:
        """One-token decode, x (B,1,d); writes this layer's K/V at
        ``pos``."""
        h = self.mixer.decode(rms_norm(self.norm1, x, self.eps), cache_k,
                              cache_v, pos)
        return self._ffn(x + h)[0]


class Stack(nn.Module):
    """``num_layers`` blocks, MoE where ``cfg.is_moe_layer(i)``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        plen = len(cfg.block_pattern)
        if cfg.num_layers % plen != 0:
            raise ValueError(
                f"{cfg.name}: num_layers {cfg.num_layers} not divisible by "
                f"block pattern period {plen}")
        self.cfg = cfg
        self.layers = nn.ModuleList(
            Block(cfg, cfg.is_moe_layer(i), dtype, device)
            for i in range(cfg.num_layers))

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Full-sequence stack. Returns ``(x, total_moe_aux)``."""
        aux_sum = torch.zeros((), device=x.device)
        for block in self.layers:
            x, aux, _, _ = block(x, positions)
            if aux is not None:
                aux_sum = aux_sum + aux
        return x, aux_sum

    def init_cache(self, batch: int, max_seq: int, dtype: torch.dtype,
                   device: torch.device) -> Cache:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Cache) -> torch.Tensor:
        """Full-sequence stack that also writes every layer's K/V into
        ``cache[:, :, :S]``."""
        s = x.shape[1]
        for i, block in enumerate(self.layers):
            x, _, k, v = block(x, positions)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        return x

    def decode(self, x: torch.Tensor, cache: Cache, pos: int) -> torch.Tensor:
        for i, block in enumerate(self.layers):
            x = block.decode(x, cache["k"][i], cache["v"][i], pos)
        return x
