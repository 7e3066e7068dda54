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

from typing import List, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from ..configs.base import ArchConfig
from ..sharding.rules import constrain, shard_local
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
        # float32 whatever the model's dtype, as the reference's
        # init_mamba leaves it
        self.a_log = empty_param(din, n, dtype=torch.float32, device=device)
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


def _causal_conv(u_raw, conv_w, conv_b):
    """silu of the depthwise causal conv over time: u_raw (B,S,din)."""
    k, s = conv_w.shape[0], u_raw.shape[1]
    u_pad = F.pad(u_raw, (0, 0, k - 1, 0))
    u = sum(u_pad[:, i:i + s] * conv_w[i] for i in range(k)) + conv_b
    return F.silu(u)


def _conv_step(window, conv_w, conv_b):
    """silu of one decode step's conv: window (B,K,din) -> (B,din)."""
    return F.silu(torch.einsum("bke,ke->be", window, conv_w) + conv_b)


def _ssm_step(dt, u, bb, cc, a, ssm_state):
    """One decode step's state update and readout (y float32)."""
    decay = torch.exp(dt.float()[..., None] * a)             # (B,din,N)
    drive = (dt.float() * u.float())[..., None] * bb.float()[:, None]
    h = decay * ssm_state + drive
    return torch.einsum("ben,bn->be", h, cc.float()), h


def _ssm_inputs(m: Mamba, x: torch.Tensor, cfg: ArchConfig):
    """Shared projections. x: (B,S,d) -> (u_raw, u, gate, dt, b, c).

    u_raw: (B,S,din) pre-conv inputs (the decode window's source; the
    reference's ``_ssm_inputs`` leaves them out); u: the conv'd inputs;
    dt: (B,S,din); b, c: (B,S,N)."""
    n = cfg.ssm_state_dim
    s = x.shape[1]
    # under a mesh the split gathers the channel-sharded projection:
    # each half is constrained back to its channels, so the conv, the
    # scan and the gate run on each rank's own, and the projection's
    # gradient is split again before ``in_proj``'s is formed from it
    xz = constrain(x @ m.in_proj, "batch", "seq", "ssm_inner")
    u_raw, gate = (constrain(t, "batch", "seq", "ssm_inner")
                   for t in xz.chunk(2, dim=-1))
    if isinstance(u_raw, DTensor):              # per row and channel
        u = shard_local(_causal_conv, u_raw, (0, 2),
                        [(0, 2), (None, 1), (None, 0)],
                        [(0, 2)])(u_raw, m.conv_w, m.conv_b)
    else:
        u = _causal_conv(u_raw, m.conv_w, m.conv_b)
    # the channel-sharded contraction's partial sums reduced here, once
    proj = constrain(u @ m.x_proj, "batch", "seq", None)
    dt_in, b, c = proj.split([DT_RANK, n, n], dim=-1)
    dt = F.softplus(dt_in @ m.dt_proj + m.dt_bias)
    return u_raw, u, gate, dt, b, c


def _scan(u, dt, b, c, a):
    if isinstance(u, FakeTensor):
        return _scan_op(u, dt, b, c, a)
    return selective_scan(u, dt, b, c, a)


def selective_scan(u, dt, b, c, a):
    """The recurrence over time: u, dt (B,S,din); b, c (B,S,N); a
    (din, N). Returns (y (B,S,din) in u's dtype, final h (B,din,N)
    float32)."""
    h = torch.zeros((u.shape[0], u.shape[-1], a.shape[-1]),
                    dtype=torch.float32, device=u.device)
    ys = []
    for t in range(u.shape[1]):
        dt_t = dt[:, t].float()
        dec = torch.exp(dt_t[..., None] * a)
        drv = (dt_t * u[:, t].float())[..., None] * b[:, t].float()[:, None]
        h = dec * h + drv
        ys.append(torch.einsum("ben,bn->be", h, c[:, t].float()))
    return torch.stack(ys, dim=1).to(u.dtype), h


# -- the scan as one op, for a trace on fake tensors ----------------------
#
# A dry-run (``launch.dryrun``) traces the step on fake tensors, op by op;
# at 32K positions the loop above is millions of ops. On fake tensors the
# scan therefore runs as one registered op whose fake version gives the
# output shapes and whose cost ``launch.roofline`` charges by
# ``scan_cost``: what the loop's ops read and write, step for step. Real
# tensors always take the loop.

@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def _scan_op(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return selective_scan(u, dt, b, c, a)


@_scan_op.register_fake
def _(u, dt, b, c, a):
    return (torch.empty_like(u),
            u.new_empty((u.shape[0], u.shape[2], a.shape[1]),
                        dtype=torch.float32))


@torch.library.custom_op("repro_torch::selective_scan_backward",
                         mutates_args=())
def _scan_bwd_op(gy: torch.Tensor, gh: torch.Tensor, u: torch.Tensor,
                 dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 a: torch.Tensor) -> List[torch.Tensor]:
    ins = [x.detach().requires_grad_(True) for x in (u, dt, b, c, a)]
    with torch.enable_grad():
        y, h = selective_scan(*ins)
    return list(torch.autograd.grad((y, h), ins, (gy, gh)))


@_scan_bwd_op.register_fake
def _(gy, gh, u, dt, b, c, a):
    return [torch.empty_like(x) for x in (u, dt, b, c, a)]


def _scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _scan_backward(ctx, gy, gh):
    return tuple(_scan_bwd_op(gy, gh, *ctx.saved_tensors))


torch.library.register_autograd("repro_torch::selective_scan",
                                _scan_backward, setup_context=_scan_setup)


def scan_cost(u_shape, n: int, el: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of ``selective_scan``'s loop at u (B, S, din), N
    states, u/dt/b/c of ``el`` bytes an element, as ``CostCounter``
    counts them: per step the float32 casts of the step's dt, u, b and
    c, the decay and drive products, the state update and the readout
    (a batched matmul, 2 B din N FLOPs); then the stack of the S
    outputs and their cast back (no cast copies in float32)."""
    bsz, s, din = u_shape
    e, en, n_ = bsz * din, bsz * din * n, bsz * n
    cast = 0 if el == 4 else el + 4             # .float() copies or not
    casts = 2 * e * cast + 2 * n_ * cast             # dt, u, b, c
    decay = (e * 4 + din * n * 4 + en * 4) + 2 * en * 4   # mul, exp
    drive = 3 * e * 4 + (e * 4 + n_ * 4 + en * 4)   # dt*u, (.)*b
    update = 2 * 3 * en * 4                          # dec*h, + drv
    readout = en * 4 + n_ * 4 + e * 4
    step_bytes = casts + decay + drive + update + readout
    tail = 2 * s * e * 4 + s * e * cast + en * 4     # stack, cast, h0
    return 2.0 * en * s, float(s * step_bytes + tail)


def mamba_block(m: Mamba, x: torch.Tensor, cfg: ArchConfig):
    """Full-sequence selective scan. x: (B,S,d). Returns (out,
    (conv_window, final_h)), the state seeding the decode cache."""
    b_, s, _ = x.shape
    k = cfg.ssm_conv_dim
    u_raw, u, gate, dt, b, c = _ssm_inputs(m, x, cfg)
    a = -torch.exp(m.a_log)                            # (din, N), negative
    if isinstance(u, DTensor):                  # per row and channel
        y, h = shard_local(_scan, u, (0, 2),
                           [(0, 2), (0, 2), (0, None), (0, None),
                            (None, 0)], [(0, 2), (0, 1)])(u, dt, b, c, a)
    else:
        y, h = _scan(u, dt, b, c, a)
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
    sharded = isinstance(window, DTensor)       # per row and channel
    if sharded:
        u = shard_local(_conv_step, window, (0, 2),
                        [(0, 2), (None, 1), (None, 0)],
                        [(0, 1)])(window, m.conv_w, m.conv_b)
    else:
        u = _conv_step(window, m.conv_w, m.conv_b)
    proj = constrain(u @ m.x_proj, "batch", None)
    dt_in, bb, cc = proj.split([DT_RANK, n, n], dim=-1)
    dt = F.softplus(dt_in @ m.dt_proj + m.dt_bias)
    a = -torch.exp(m.a_log)
    args = (dt, u, bb, cc, a, ssm_state)
    if sharded:
        y, h = shard_local(_ssm_step, dt, (0, 1),
                           [(0, 1), (0, 1), (0, None), (0, None), (None, 0),
                            (0, 1)], [(0, 1), (0, 1)])(*args)
    else:
        y, h = _ssm_step(*args)
    y = y.to(x.dtype) + m.d_skip * u
    y = y * F.silu(gate)
    return (y @ m.out_proj)[:, None], window[:, 1:], h
