"""AdamW with decoupled weight decay, float32 moments and global-norm
clipping, and the learning-rate schedules (the PyTorch counterpart of
``repro.train.optimizer``; not ``torch.optim.AdamW``, which decays
before the moment update and does not clip).

Parameters, gradients and moments are dicts keyed by parameter name
(``dict(model.named_parameters())``). Each step computes, in float32,
as the reference does:

* ``g *= min(1, clip_norm / (global_norm(g) + 1e-9))``;
* ``step = state.step + 1``, then ``mu = b1 mu + (1 - b1) g``,
  ``nu = b2 nu + (1 - b2) g^2`` and the bias corrections ``1 - b^step``;
* ``u = mhat / (sqrt(nhat) + eps) + weight_decay * p`` and the update
  ``-lr(step) * u``, which ``apply_updates`` adds to the parameters.

``update`` writes the new moments into the state's own tensors (the
reference returns new ones; its launchers donate the old), and
``apply_updates`` adds in place: at 1.5B parameters a second copy of
either is 6 GB.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Params = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    mu: Dict[str, torch.Tensor]     # first moment (float32)
    nu: Dict[str, torch.Tensor]     # second moment (float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: Params) -> AdamWState:
        """Zero moments in float32 beside each parameter, step 0."""
        device = next(iter(params.values())).device
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                 for n, p in params.items()}
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=zeros, nu={n: z.clone() for n, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> Tuple[Dict[str, torch.Tensor], AdamWState,
                          Dict[str, torch.Tensor]]:
        """Returns (updates, state, {"grad_norm", "lr"}): the updates to
        add to ``params``, and ``state`` holding the new moments and
        step. ``grad_norm`` is the norm before clipping."""
        names = list(params)
        g = [grads[n].float() for n in names]
        gnorm = global_norm(g)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            g = torch._foreach_mul(g, scale)

        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        del g
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self.learning_rate(step)

        updates = {}
        for n, m, v in zip(names, mu, nu, strict=True):
            p = params[n]
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            updates[n] = (-lr * u).to(p.dtype)
        return (updates, AdamWState(step=step, mu=state.mu, nu=state.nu),
                {"grad_norm": gnorm, "lr": lr})


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """``p += u`` for every parameter, in place; returns ``params``."""
    names = list(params)
    torch._foreach_add_([params[n] for n in names],
                        [updates[n] for n in names])
    return params


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of the sum of squares, in float32 (a
    dict's values or a sequence)."""
    if isinstance(tensors, Mapping):
        tensors = list(tensors.values())
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tensors]).sum())


def warmup_cosine(peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return peak_lr * torch.minimum(warm, cos)

    return schedule


def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)
