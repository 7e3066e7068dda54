"""Mamba (selective SSM) blocks of the port, the recurrent layers of
Jamba (the PyTorch counterpart of ``repro.models.mamba``).

Selective scan: per-channel state ``h_t = exp(dt_t * A) h_{t-1} +
dt_t * B_t x_t`` with input-dependent ``B_t, C_t, dt_t`` and readout
``y_t = C_t . h_t + D * x_t``. As in the reference, the full-sequence
path is a sequential scan over time with the (B, din, N) state in
float32: the decay varies per (channel, state) pair, so a chunked form
would need a (chunk x chunk x N) grid per channel. Decay and drive are
formed inside the step from that step's slices, never as (B, S, din, N)
tensors. The decode path is one fused state update.

The functions take the module holding the parameters where the
reference takes its parameter dict; ``mamba_block`` always returns the
state that seeds the decode cache (``(conv_window, final_h)``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ArchConfig
from .layers import empty_param

DT_RANK = 64


class Mamba(nn.Module):
    """``in_proj [d, 2*din]``, depthwise causal conv ``conv_w [K, din]``
    and ``conv_b [din]``, ``x_proj [din, DT_RANK + 2N]``, ``dt_proj
    [DT_RANK, din]`` and ``dt_bias [din]``, ``a_log [din, N]``, ``d_skip
    [din]``, ``out_proj [din, d]``. The decode state is the last K-1
    pre-conv inputs and the SSM state."""

    STATE = ("conv", "ssm")

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        d = cfg.d_model
        din = cfg.ssm_expand * d
        n = cfg.ssm_state_dim
        self.cfg = cfg

        def param(*shape):
            return empty_param(*shape, dtype=dtype, device=device)

        self.in_proj = param(d, 2 * din)
        self.conv_w = param(cfg.ssm_conv_dim, din)
        self.conv_b = param(din)
        self.x_proj = param(din, DT_RANK + 2 * n)
        self.dt_proj = param(DT_RANK, din)
        self.dt_bias = param(din)
        self.a_log = param(din, n)
        self.d_skip = param(din)
        self.out_proj = param(din, d)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        return mamba_block(self, x, self.cfg)

    def decode(self, x: torch.Tensor, state, pos: int) -> torch.Tensor:
        """One token; ``state`` is this layer's ``(conv, ssm)`` cache,
        updated in place."""
        conv, ssm = state
        y, new_conv, new_ssm = mamba_decode(self, x, self.cfg, conv, ssm)
        conv.copy_(new_conv)
        ssm.copy_(new_ssm)
        return y


def _ssm_inputs(m: Mamba, x: torch.Tensor, cfg: ArchConfig):
    """Shared projections. x: (B,S,d) -> (u_raw, u, gate, dt, b, c).

    u_raw: (B,S,din) pre-conv inputs (the decode window's source; the
    reference's ``_ssm_inputs`` leaves them out); u: the conv'd inputs;
    dt: (B,S,din); b, c: (B,S,N)."""
    n = cfg.ssm_state_dim
    s = x.shape[1]
    u_raw, gate = (x @ m.in_proj).chunk(2, dim=-1)
    k = m.conv_w.shape[0]
    u_pad = F.pad(u_raw, (0, 0, k - 1, 0))
    u = sum(u_pad[:, i:i + s] * m.conv_w[i] for i in range(k)) + m.conv_b
    u = F.silu(u)
    dt_in, b, c = (u @ m.x_proj).split([DT_RANK, n, n], dim=-1)
    dt = F.softplus(dt_in @ m.dt_proj + m.dt_bias)
    return u_raw, u, gate, dt, b, c


def mamba_block(m: Mamba, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence selective scan. x: (B,S,d). Returns (out,
    (conv_window, final_h)), the state seeding the decode cache."""
    b_, s, _ = x.shape
    k = cfg.ssm_conv_dim
    u_raw, u, gate, dt, b, c = _ssm_inputs(m, x, cfg)
    a = -torch.exp(m.a_log)                            # (din, N), negative

    h = torch.zeros((b_, u.shape[-1], cfg.ssm_state_dim),
                    dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dt_t = dt[:, t].float()
        dec = torch.exp(dt_t[..., None] * a)
        drv = (dt_t * u[:, t].float())[..., None] * b[:, t].float()[:, None]
        h = dec * h + drv
        ys.append(torch.einsum("ben,bn->be", h, c[:, t].float()))
    y = torch.stack(ys, dim=1).to(x.dtype)              # (B,S,din)
    y = y + m.d_skip * u
    y = y * F.silu(gate)
    out = y @ m.out_proj
    # decode conv state = the last K-1 raw (pre-conv) inputs
    if s >= k - 1:
        conv_window = u_raw[:, s - (k - 1):]
    else:
        conv_window = F.pad(u_raw, (0, 0, k - 1 - s, 0))
    return out, (conv_window, h)


def mamba_decode(m: Mamba, x: torch.Tensor, cfg: ArchConfig,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One-token decode. x: (B,1,d); conv_state: (B,K-1,din); ssm_state:
    (B,din,N). Returns (y, new_conv_state, new_ssm_state)."""
    n = cfg.ssm_state_dim
    u_raw, gate = (x[:, 0] @ m.in_proj).chunk(2, dim=-1)     # (B,din)
    window = torch.cat([conv_state, u_raw[:, None]], dim=1)
    u = torch.einsum("bke,ke->be", window, m.conv_w) + m.conv_b
    u = F.silu(u)
    dt_in, bb, cc = (u @ m.x_proj).split([DT_RANK, n, n], dim=-1)
    dt = F.softplus(dt_in @ m.dt_proj + m.dt_bias)
    a = -torch.exp(m.a_log)
    decay = torch.exp(dt.float()[..., None] * a)             # (B,din,N)
    drive = (dt.float() * u.float())[..., None] * bb.float()[:, None]
    h = decay * ssm_state + drive
    y = torch.einsum("ben,bn->be", h, cc.float()).to(x.dtype)
    y = y + m.d_skip * u
    y = y * F.silu(gate)
    return (y @ m.out_proj)[:, None], window[:, 1:], h
