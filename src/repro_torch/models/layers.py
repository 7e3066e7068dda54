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
``ATTN_CHUNK`` for long sequences. Decoder attention masks causally and
nothing else: left-padded prompts attend to their pad tokens, as in the
reference, so attention is not routed through
``scaled_dot_product_attention``. The encoder's self-attention and the
cross-attention do not mask.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.nn import functional as F

from ..configs.base import ArchConfig
from ..sharding.rules import constrain, local_inputs

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


# Leaves drawn from a normal of a fixed standard deviation, and leaves
# filled with a constant, at init (the reference's ``init_embeddings``,
# ``init_mamba`` and ``init_time_mix``/``init_channel_mix``).
NORMAL_STD = {"tok": EMBED_INIT_STD, "conv_w": 0.2, "u": 0.3}
FILL = {"mu": 0.5, "w0": -0.6, "dt_bias": -4.6, "d_skip": 1.0,
        "ln_scale": 1.0}


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random init with the reference's distributions, drawn in float32
    from ``generator`` (on the parameters' device) in parameter order:

    * matrices ``[..., d_in, d_out]``: normal, std ``d_in ** -0.5``
      (``dense_param``, the untied ``out`` head, ``init_moe``, the Mamba
      and RWKV projections);
    * ``NORMAL_STD``'s leaves: normal of that std (the token table
      ``tok`` 0.02, Mamba's ``conv_w`` 0.2, RWKV's bonus ``u`` 0.3);
    * ``FILL``'s leaves: that constant (RWKV's lerps ``mu`` 0.5 and decay
      bias ``w0`` -0.6, Mamba's ``dt_bias`` -4.6, ...);
    * Mamba's ``a_log [din, N]``: ``log(1..N)`` in every row;
    * norm scales: ones; biases: zeros.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in FILL:
            p.fill_(FILL[leaf])
        elif leaf == "a_log":
            n = p.shape[-1]
            p.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                           device=p.device)).expand(p.shape))
        elif leaf in NORMAL_STD or p.dim() >= 2:
            std = NORMAL_STD.get(leaf) or p.shape[-2] ** -0.5
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
        if isinstance(self.tok, DTensor):
            return _sharded_lookup(self.tok, tokens)
        return self.tok[tokens]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        if self.tied:
            return x @ self.tok.t()
        return x @ self.out


def _sharded_lookup(tok: DTensor, tokens: torch.Tensor) -> DTensor:
    """Vocab-parallel lookup: each rank gathers the rows of its own
    vocabulary shard (zeros for tokens outside it), a partial sum over
    the model axis that the caller's constraint reduces. Rows of every
    token on this rank's batch shard; the table's features whole."""
    mesh = tok.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    vocab_sharded = tok.placements[mi].is_shard(0)
    t_pl = [Replicate()] * mesh.ndim
    t_pl[mi] = Shard(0) if vocab_sharded else Replicate()
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    i_pl = [p if p.is_shard(0) and i != mi else Replicate()
            for i, p in enumerate(tokens.placements)]
    out_pl = list(i_pl)
    out_pl[mi] = Partial() if vocab_sharded else Replicate()
    t_grad = [Partial() if i != mi else p for i, p in enumerate(t_pl)]

    def lookup(tokens, table):
        rows = table.shape[0]
        lo = mesh.get_local_rank("model") * rows if vocab_sharded else 0
        idx = tokens.long() - lo
        inside = (idx >= 0) & (idx < rows)
        out = table[idx.clamp(0, rows - 1)]
        return out * inside[..., None].to(out.dtype)

    return local_map(local_inputs(lookup), out_placements=out_pl,
                     in_placements=(i_pl, t_pl),
                     in_grad_placements=(i_pl, t_grad), device_mesh=mesh,
                     redistribute_inputs=True)(tokens, tok)


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


def softmax(scores: torch.Tensor) -> torch.Tensor:
    """Softmax in float32 over the last axis, unmasked (the encoder's
    self-attention and cross-attention)."""
    return F.softmax(scores.float(), dim=-1).to(scores.dtype)


def split_heads(x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd). Under a mesh, features
    sharded over more ranks than divide ``heads`` (12 heads on an 8-way
    model axis) are gathered first: a head cannot be split."""
    if isinstance(x, DTensor):
        ranks = 1
        for i, p in enumerate(x.placements):
            if p.is_shard(2):
                ranks *= x.device_mesh.size(i)
        if heads % ranks:
            x = constrain(x, "batch", "seq", None)
    return x.reshape(*x.shape[:2], heads, hd)


def _heads_sharded(x: torch.Tensor) -> bool:
    return any(p.is_shard(2) for p in x.placements)


def kv_like_queries(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_kv_heads: int):
    """Under a mesh, where the query heads are sharded and the KV heads
    cannot be (fewer of them than the model axis), each query head gets
    its own copy of its KV head, sharded as the queries are (Megatron's
    replicated KV heads): every rank then attends with its own query
    heads. Elsewhere ``(k, v, num_kv_heads)`` as they are."""
    if not isinstance(q, DTensor) or not _heads_sharded(q) \
            or _heads_sharded(k):
        return k, v, num_kv_heads
    hq = q.shape[2]
    g = hq // num_kv_heads

    def spread(x):
        b, s, _, hd = x.shape
        x = x[:, :, :, None].expand(b, s, num_kv_heads, g, hd)
        return constrain(x.reshape(b, s, hq, hd), "batch", None,
                         "act_heads", None)

    return spread(k), spread(v), hq


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           probs_fn) -> torch.Tensor:
    """``gqa_out(probs_fn(gqa_scores(q, k)), v)`` -> (B,Sq,Hq*hd), the
    KV heads those of ``k``.

    On ``DTensor``s the attention of a batch row and head never needs
    another's, so it runs through ``local_map`` on each rank's shards
    (k and v placed as q): DTensor's own einsum strategy would fold the
    data-sharded batch and the model-sharded heads into one bmm
    dimension, which it can only express as a strided shard."""
    def core(q, k, v):
        return gqa_out(probs_fn(gqa_scores(q, k, k.shape[2])), v)

    if not isinstance(q, DTensor):
        return core(q, k, v)
    pl = tuple(q.placements)
    return local_map(local_inputs(core), out_placements=list(pl),
                     in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


class Attention(nn.Module):
    """Self-attention with grouped KV heads and an optional QKV bias
    (``wq [d, Hq*hd]``, ``wk``/``wv [d, Hkv*hd]``, ``wo [Hq*hd, d]``),
    causal unless built with ``causal=False`` (the encoder's). ``cross``
    uses the same weights as an encoder-decoder cross-attention.

    The decode state of a layer is ``STATE``: its K and V caches."""

    STATE = ("k", "v")

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, causal: bool = True) -> None:
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.cfg = cfg
        self.causal = causal
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

    def _heads(self, x: torch.Tensor, kv: torch.Tensor):
        """Queries from ``x``, keys and values from ``kv``, split into
        heads, unrotated."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        q, k, v = x @ self.wq, kv @ self.wk, kv @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return (split_heads(q, cfg.num_heads, hd),
                split_heads(k, cfg.num_kv_heads, hd),
                split_heads(v, cfg.num_kv_heads, hd))

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor):
        q, k, v = self._heads(x, x)
        q = constrain(q, "batch", "seq", "act_heads", None)
        k = constrain(k, "batch", "seq", "act_kv_heads", None)
        v = constrain(v, "batch", "seq", "act_kv_heads", None)
        if self.cfg.rope:
            hd = self.cfg.resolved_head_dim
            q = apply_rope(q, positions, hd)
            k = apply_rope(k, positions, hd)
        return q, k, v

    def _probs(self, scores: torch.Tensor, q_pos: torch.Tensor,
               k_pos: torch.Tensor) -> torch.Tensor:
        if self.causal:
            return masked_softmax(scores, q_pos[:, None] >= k_pos[None, :])
        return softmax(scores)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Self-attention for train/prefill. Returns ``(out, (k, v))``
        with the rotated K/V, so that prefill fills the decode cache in
        the same pass.

        For S > ATTN_CHUNK_THRESHOLD with S a multiple of ATTN_CHUNK,
        loops over query chunks, so the live score buffer is
        (chunk x S) instead of (S x S)."""
        b, s, _ = x.shape
        q, k, v = self.project_qkv(x, positions)
        ka, va, _ = kv_like_queries(q, k, v, self.cfg.num_kv_heads)
        # every row's positions are the same: a rank's first row serves
        pos = (positions.to_local() if isinstance(positions, DTensor)
               else positions)[0]
        chunk = ATTN_CHUNK
        if s <= ATTN_CHUNK_THRESHOLD or s % chunk != 0:
            out = attend(q, ka, va, lambda sc: self._probs(sc, pos, pos))
        else:
            outs = []
            for lo in range(0, s, chunk):
                q_pos = pos[lo:lo + chunk]
                outs.append(attend(
                    q[:, lo:lo + chunk], ka, va,
                    lambda sc, q_pos=q_pos: self._probs(sc, q_pos, pos)))
            out = torch.cat(outs, dim=1)
        return self._project_out(out), (k, v)

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        """``out @ wo``, with ``out`` (B, S, Hq*hd) constrained as
        ``wo``'s rows are sharded: where the heads were gathered (they
        do not divide the model axis) the features still split evenly,
        and ``wo``'s gradient, ``out^T @ grad``, is then formed as the
        rules shard ``wo`` rather than replicated over the model
        axis."""
        return constrain(out, "batch", "seq", "act_heads") @ self.wo

    def cross(self, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """Encoder-decoder cross-attention: queries from x (B,Sq,d), keys
        and values from enc_out (B,Sk,d). No rotation, no mask."""
        q, k, v = self._heads(x, enc_out.to(x.dtype))
        return self._project_out(attend(q, k, v, softmax))

    def decode(self, x: torch.Tensor, state, pos: int) -> torch.Tensor:
        """One-token decode: x (B,1,d); ``state`` this layer's
        ``(cache_k, cache_v)``, each (B,S,Hkv,hd). Writes the new K/V at
        ``pos`` in place and attends to positions ``<= pos``."""
        cache_k, cache_v = state
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.long,
                               device=x.device)
        q, k, v = self.project_qkv(x, positions)
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        s = cache_k.shape[1]
        ka, va, _ = kv_like_queries(q, cache_k, cache_v,
                                    self.cfg.num_kv_heads)
        mask = torch.arange(s, device=x.device) <= pos
        return attend(q, ka, va,
                      lambda sc: masked_softmax(sc, mask)) @ self.wo


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
