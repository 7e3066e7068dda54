"""Core model layers of the port (the PyTorch counterpart of
``repro.models.layers``).

Each layer is an ``nn.Module`` whose parameters carry the JAX package's
names and layouts: a projection is a ``[d_in, d_out]`` matrix applied as
``x @ w``, an embedding table is ``[vocab, d_model]``. So
``models.convert`` copies the reference's parameter pytree leaf for leaf,
and both packages compute the same function on the same weights.

The arithmetic follows the reference step for step: RMSNorm in float32,
RoPE on split halves (NeoX layout) in float32 with theta 10000, grouped
query attention with the query heads grouped as ``(Hkv, G)``, masked
scores filled with ``-1e30`` and softmax in float32, query chunks of
``ATTN_CHUNK`` for long sequences. Attention masks causally and nothing
else: left-padded prompts attend to their pad tokens, as in the
reference, so attention is not routed through
``scaled_dot_product_attention``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ArchConfig

# Default attention q-chunk (queries per step for long sequences).
ATTN_CHUNK = 1024
# Sequences at or below this use unchunked attention.
ATTN_CHUNK_THRESHOLD = 2048
# Fill of masked scores (the reference's; finite, unlike -inf).
MASK_FILL = -1e30
# Standard deviation of the token embedding table at init.
EMBED_INIT_STD = 0.02


# ---------------------------------------------------------------------------
# Param helpers
# ---------------------------------------------------------------------------

def empty_param(*shape: int, dtype: torch.dtype,
                device: torch.device) -> nn.Parameter:
    """An uninitialised parameter: ``init_parameters`` (random init) or
    ``models.convert`` (the reference's weights) fills it."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random init with the reference's distributions, drawn in float32
    from ``generator`` (on the parameters' device) in parameter order:

    * matrices ``[..., d_in, d_out]``: normal, std ``d_in ** -0.5``
      (``dense_param``, the untied ``out`` head, ``init_moe``);
    * the token table ``tok``: normal, std 0.02;
    * norm scales: ones; QKV biases: zeros.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() >= 2:
            std = (EMBED_INIT_STD if leaf == "tok"
                   else p.shape[-2] ** -0.5)
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                    * std)
        elif leaf.startswith("norm"):
            p.fill_(1.0)
        else:
            p.zero_()


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

class Embeddings(nn.Module):
    """Token table ``tok [V, d]`` and, untied, the head ``out [d, V]``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.tied = cfg.tie_embeddings
        self.tok = empty_param(cfg.vocab_size, cfg.d_model, dtype=dtype,
                               device=device)
        if not self.tied:
            self.out = empty_param(cfg.d_model, cfg.vocab_size,
                                   dtype=dtype, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok[tokens]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        if self.tied:
            return x @ self.tok.t()
        return x @ self.out


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, device: torch.device,
               theta: float = 10000.0) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               head_dim: int) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    freqs = rope_freqs(head_dim, x.device)
    angles = positions[..., None].float() * freqs      # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA), train/prefill and decode-with-cache paths
# ---------------------------------------------------------------------------

def gqa_scores(q: torch.Tensor, k: torch.Tensor,
               num_kv_heads: int) -> torch.Tensor:
    """q: (B,Sq,Hq,hd), k: (B,Sk,Hkv,hd) -> scores (B,Hkv,G,Sq,Sk)."""
    b, sq, hq, hd = q.shape
    g = hq // max(num_kv_heads, 1)
    qg = q.reshape(b, sq, num_kv_heads, g, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) * float(hd ** -0.5)


def gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,Hkv,G,Sq,Sk), v: (B,Sk,Hkv,hd) -> (B,Sq,Hq*hd)."""
    b, hkv, g, sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, hkv * g * v.shape[-1])


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax in float32 over the last axis, with the scores where
    ``mask`` is false set to ``MASK_FILL`` first."""
    scores = scores.masked_fill(~mask, MASK_FILL)
    return F.softmax(scores.float(), dim=-1).to(scores.dtype)


class Attention(nn.Module):
    """Causal self-attention with grouped KV heads and an optional QKV
    bias (``wq [d, Hq*hd]``, ``wk``/``wv [d, Hkv*hd]``, ``wo [Hq*hd, d]``).
    """

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.cfg = cfg
        self.wq = empty_param(d, cfg.num_heads * hd, dtype=dtype,
                              device=device)
        self.wk = empty_param(d, cfg.num_kv_heads * hd, dtype=dtype,
                              device=device)
        self.wv = empty_param(d, cfg.num_kv_heads * hd, dtype=dtype,
                              device=device)
        self.wo = empty_param(cfg.num_heads * hd, d, dtype=dtype,
                              device=device)
        if cfg.qkv_bias:
            self.bq = empty_param(cfg.num_heads * hd, dtype=dtype,
                                  device=device)
            self.bk = empty_param(cfg.num_kv_heads * hd, dtype=dtype,
                                  device=device)
            self.bv = empty_param(cfg.num_kv_heads * hd, dtype=dtype,
                                  device=device)

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(b, s, cfg.num_heads, hd)
        k = k.reshape(b, s, cfg.num_kv_heads, hd)
        v = v.reshape(b, s, cfg.num_kv_heads, hd)
        if cfg.rope:
            q = apply_rope(q, positions, hd)
            k = apply_rope(k, positions, hd)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Causal self-attention for train/prefill. Returns
        ``(out, k, v)`` with the rotated K/V, so that prefill fills the
        decode cache in the same pass.

        For S > ATTN_CHUNK_THRESHOLD with S a multiple of ATTN_CHUNK,
        loops over query chunks, so the live score buffer is
        (chunk x S) instead of (S x S)."""
        b, s, _ = x.shape
        kv_heads = self.cfg.num_kv_heads
        q, k, v = self.project_qkv(x, positions)
        pos = positions[0]
        chunk = ATTN_CHUNK
        if s <= ATTN_CHUNK_THRESHOLD or s % chunk != 0:
            probs = masked_softmax(gqa_scores(q, k, kv_heads),
                                   pos[:, None] >= pos[None, :])
            out = gqa_out(probs, v)
        else:
            outs = []
            for lo in range(0, s, chunk):
                qi = pos[lo:lo + chunk]
                probs = masked_softmax(
                    gqa_scores(q[:, lo:lo + chunk], k, kv_heads),
                    qi[:, None] >= pos[None, :])
                outs.append(gqa_out(probs, v))
            out = torch.cat(outs, dim=1)
        return out @ self.wo, k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int) -> torch.Tensor:
        """One-token decode: x (B,1,d); cache_[kv] (B,S,Hkv,hd). Writes
        the new K/V at ``pos`` in place and attends to positions
        ``<= pos``."""
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.long,
                               device=x.device)
        q, k, v = self.project_qkv(x, positions)
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        s = cache_k.shape[1]
        scores = gqa_scores(q, cache_k, self.cfg.num_kv_heads)
        mask = torch.arange(s, device=x.device) <= pos
        probs = masked_softmax(scores, mask)
        return gqa_out(probs, cache_v) @ self.wo


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

class FFN(nn.Module):
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, d_ff: Optional[int] = None) -> None:
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = empty_param(d, ff, dtype=dtype, device=device)
        self.w_up = empty_param(d, ff, dtype=dtype, device=device)
        self.w_down = empty_param(ff, d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
