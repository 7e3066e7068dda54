"""RWKV6 ("Finch") blocks of the port: attention-free, with data-dependent
decay (the PyTorch counterpart of ``repro.models.rwkv``).

Time-mix (WKV6): per-head matrix-valued recurrent state
``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` with per-channel decay
``w_t = exp(-exp(w0 + lora(x_t)))``, read out as
``o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)``.

``wkv_chunked`` is the reference's chunked parallel form: within a chunk
of C steps every pairwise decay ``exp(cum_{t-1} - cum_j)`` (j < t) has a
non-positive exponent, so the intra-chunk part is a masked product over
a ``(B, C, C, H, N)`` decay tensor and the state carries across chunks.
``wkv_reference`` is the step-by-step oracle and ``wkv_step`` the decode
update. Channel-mix is RWKV's two-matrix FFN with receptance gating.

The functions take the module holding the parameters where the
reference takes its parameter dict; ``time_mix`` always returns the
state that seeds the decode cache (``(x_last, wkv_state)``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from ..configs.base import ArchConfig
from ..sharding.rules import constrain, shard_local
from .layers import empty_param

LORA_DIM = 64

F32 = torch.float32


# ---------------------------------------------------------------------------
# WKV6 core
# ---------------------------------------------------------------------------

def wkv_reference(r, k, v, logw, u):
    """Sequential oracle. r,k,v,logw: (B,S,H,N); u: (H,N).

    Returns (o: (B,S,H,N), final_state: (B,H,N,N))."""
    b, s, h, n = r.shape
    state = torch.zeros((b, h, n, n), dtype=F32, device=r.device)
    outs = []
    for t in range(s):
        rt, kt, vt, lw = (x[:, t].float() for x in (r, k, v, logw))
        kv = kt[..., :, None] * vt[..., None, :]
        bonus = state + u[None, :, :, None] * kv
        outs.append(torch.einsum("bhn,bhnm->bhm", rt, bonus))
        state = torch.exp(lw)[..., :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state


def wkv_chunked(r, k, v, logw, u, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked-parallel WKV6. Shapes as ``wkv_reference``.

    All decay exponents are differences ``cum_a - cum_b`` with a >= b in
    time order, hence <= 0: numerically safe in float32 at any chunk
    size. A sequence that is not a multiple of ``chunk`` is padded with
    zeros (the returned state is then the padded sequence's)."""
    b, s, h, n = r.shape
    if s % chunk != 0:
        pad = chunk - s % chunk
        out, st = wkv_chunked(*(F.pad(x, (0, 0, 0, 0, 0, pad))
                                for x in (r, k, v, logw)),
                              u, chunk, initial_state)
        return out[:, :s], st
    state = (initial_state if initial_state is not None
             else torch.zeros((b, h, n, n), dtype=F32, device=r.device))
    t_idx = torch.arange(chunk, device=r.device)
    causal = (t_idx[:, None] > t_idx[None, :])[None, :, :, None, None]
    outs = []
    for lo in range(0, s, chunk):
        # each chunk is cast to float32 on its own: a whole-sequence copy
        # would be four more (B,S,H,N) float32 buffers
        rt, kt, vt, lw = (x[:, lo:lo + chunk].float()
                          for x in (r, k, v, logw))
        cum = torch.cumsum(lw, dim=1)       # inclusive, (B,C,H,N)
        ecum = cum - lw                     # exclusive (cum_{t-1})
        # intra-chunk: A[t,j] = r_t . (k_j * exp(ecum_t - cum_j)), j < t
        pair = ecum[:, :, None] - cum[:, None]        # (B,C,C,H,N)
        pair = torch.where(causal, pair, -torch.inf)
        a = torch.einsum("bthn,bjhn,btjhn->bthj", rt, kt, torch.exp(pair))
        diag = torch.einsum("bthn,hn,bthn->bth", rt, u, kt)
        o = torch.einsum("bthj,bjhn->bthn", a, vt)
        o = o + diag[..., None] * vt
        # inter-chunk: r_t * exp(ecum_t) @ state
        o = o + torch.einsum("bthn,bhnm->bthm", rt * torch.exp(ecum), state)
        # state update to the chunk's end
        kdec = kt * torch.exp(cum[:, -1:] - cum)
        state = (torch.exp(cum[:, -1])[..., None] * state
                 + torch.einsum("bthn,bthm->bhnm", kdec, vt))
        outs.append(o)
    return torch.cat(outs, dim=1).to(r.dtype), state


def wkv_step(r, k, v, logw, u, state):
    """Single-token decode. r,k,v,logw: (B,H,N); state: (B,H,N,N)."""
    rt, kt, vt, lw = (x.float() for x in (r, k, v, logw))
    kv = kt[..., :, None] * vt[..., None, :]
    o = torch.einsum("bhn,bhnm->bhm", rt, state + u[None, :, :, None] * kv)
    new_state = torch.exp(lw)[..., :, None] * state + kv
    return o.to(r.dtype), new_state


# ---------------------------------------------------------------------------
# Time-mix block
# ---------------------------------------------------------------------------

class TimeMix(nn.Module):
    """``mu [5, d]`` (r, k, v, g, w token-shift lerps), ``w_r``/``w_k``/
    ``w_v``/``w_g``/``w_o [d, d]``, decay bias ``w0 [d]`` and LoRA
    ``w_lora_a [d, 64]``/``w_lora_b [64, d]``, bonus ``u [d]``, per-head
    norm scale ``ln_scale [d]``. The decode state is the previous token's
    input and the WKV state."""

    STATE = ("shift_t", "wkv")

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg

        def param(*shape):
            return empty_param(*shape, dtype=dtype, device=device)

        self.mu = param(5, d)
        self.w_r, self.w_k, self.w_v = param(d, d), param(d, d), param(d, d)
        self.w_g, self.w_o = param(d, d), param(d, d)
        self.w0 = param(d)
        self.w_lora_a = param(d, LORA_DIM)
        self.w_lora_b = param(LORA_DIM, d)
        self.u = param(d)
        self.ln_scale = param(d)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        return time_mix(self, x, self.cfg)

    def decode(self, x: torch.Tensor, state, pos: int) -> torch.Tensor:
        """One token; ``state`` is this layer's ``(shift_t, wkv)`` cache,
        updated in place."""
        shift, wkv = state
        out, new_shift, new_wkv = time_mix_decode(self, x, self.cfg, shift,
                                                  wkv)
        shift.copy_(new_shift)
        wkv.copy_(new_wkv)
        return out


def _mix_inputs(mu: torch.Tensor, x: torch.Tensor, xx: torch.Tensor):
    """Token-shift lerps ``x + (xx - x) * mu[i]`` for each row of mu."""
    mu = mu.to(x.dtype)
    return [x + (xx - x) * mu[i] for i in range(mu.shape[0])]


def _shift_local(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's input at each position (zeros at the first);
    per row and channel on a ``DTensor``."""
    if isinstance(x, DTensor):
        return shard_local(_shift_local, x, (0, 2), [(0, 2)], [(0, 2)])(x)
    return _shift_local(x)


def _decay(tm: TimeMix, w_in: torch.Tensor) -> torch.Tensor:
    low = constrain(torch.tanh(w_in) @ tm.w_lora_a, "batch", "seq", None)
    lora = low @ tm.w_lora_b
    return -torch.exp(torch.clamp(tm.w0.float() + lora.float(), -8.0, 4.0))


def _group_norm(x: torch.Tensor, scale, eps: float) -> torch.Tensor:
    """Per-head RMS norm: x (..., H, N)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def time_mix(tm: TimeMix, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence time-mix. x: (B, S, d). Returns (out, (x_last,
    wkv_state)), the state seeding the decode cache after a prefill."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    r_in, k_in, v_in, g_in, w_in = _mix_inputs(tm.mu, x, _shift(x))
    r = (r_in @ tm.w_r).reshape(b, s, h, hd)
    k = (k_in @ tm.w_k).reshape(b, s, h, hd)
    v = (v_in @ tm.w_v).reshape(b, s, h, hd)
    g = F.silu(g_in @ tm.w_g)
    logw = _decay(tm, w_in).reshape(b, s, h, hd)
    u = tm.u.float().reshape(h, hd)
    if isinstance(r, DTensor):              # per row and head
        o, state = shard_local(
            lambda *a: wkv_chunked(*a, cfg.chunk_size), r, (0, 2),
            [(0, 2)] * 4 + [(None, 0)], [(0, 2), (0, 1)])(r, k, v, logw, u)
    else:
        o, state = wkv_chunked(r, k, v, logw, u, cfg.chunk_size)
    o = _group_norm(o, 1.0, cfg.norm_eps).reshape(b, s, d)
    o = o * tm.ln_scale.to(o.dtype) * g
    return o @ tm.w_o, (x[:, -1:], state)


def time_mix_decode(tm: TimeMix, x: torch.Tensor, cfg: ArchConfig,
                    shift_state: torch.Tensor, wkv_state: torch.Tensor):
    """One-token decode. x: (B,1,d); shift_state: (B,1,d); wkv_state:
    (B,H,N,N). Returns (out, new_shift, new_wkv)."""
    b, _, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    r_in, k_in, v_in, g_in, w_in = _mix_inputs(tm.mu, x, shift_state)
    r = (r_in @ tm.w_r).reshape(b, h, hd)
    k = (k_in @ tm.w_k).reshape(b, h, hd)
    v = (v_in @ tm.w_v).reshape(b, h, hd)
    g = F.silu(g_in @ tm.w_g).reshape(b, h, hd)
    logw = _decay(tm, w_in).reshape(b, h, hd)
    u = tm.u.float().reshape(h, hd)
    if isinstance(r, DTensor):              # per row and head
        o, new_state = shard_local(
            wkv_step, r, (0, 1), [(0, 1)] * 4 + [(None, 0), (0, 1)],
            [(0, 1), (0, 1)])(r, k, v, logw, u, wkv_state)
    else:
        o, new_state = wkv_step(r, k, v, logw, u, wkv_state)
    o = _group_norm(o, 1.0, cfg.norm_eps)
    o = o * tm.ln_scale.to(o.dtype).reshape(h, hd) * g
    return o.reshape(b, 1, d) @ tm.w_o, x, new_state


# ---------------------------------------------------------------------------
# Channel-mix block
# ---------------------------------------------------------------------------

class ChannelMix(nn.Module):
    """``mu [2, d]`` (k, r lerps), ``w_k [d, ff]``, ``w_v [ff, d]``,
    ``w_r [d, d]``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.mu = empty_param(2, d, dtype=dtype, device=device)
        self.w_k = empty_param(d, ff, dtype=dtype, device=device)
        self.w_v = empty_param(ff, d, dtype=dtype, device=device)
        self.w_r = empty_param(d, d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                shift_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        return channel_mix(self, x, shift_state)


def channel_mix(cm: ChannelMix, x: torch.Tensor,
                shift_state: Optional[torch.Tensor] = None) -> torch.Tensor:
    xx = _shift(x) if shift_state is None else shift_state
    k_in, r_in = _mix_inputs(cm.mu, x, xx)
    k = torch.square(F.relu(k_in @ cm.w_k))
    return torch.sigmoid(r_in @ cm.w_r) * (k @ cm.w_v)
