"""Train, gradient, prefill and serve steps for every architecture (the
PyTorch counterpart of ``repro.launch.steps``).

The reference's steps are pure functions of ``params`` that its
launchers jit and shard. Here the model owns its parameters: a step
takes ``params`` as ``dict(model.named_parameters())`` (the model's own
tensors, checked), runs autograd through the model, and updates the
parameters and the optimizer state in place, as the reference's
launchers donate them. The prefill and serve steps take no ``params``.

``grad_axes`` (the parameters' logical axes, ``models.axes.param_axes``)
ZeRO-shards the gradients over the data axis of a mesh through
``sharding.rules.constrain``, as the reference's does: under active
rules a ``DTensor`` gradient that is a partial sum over the data axis is
reduce-scattered there, and without rules the constraint is a no-op. A
parameter the rules shard over the data axis themselves has its
gradient reduce-scattered in the backward already
(``sharding.rules.sharded_param_grads``).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ..models.model import Model
from ..sharding.rules import constrain, sharded_param_grads
from ..train.optimizer import AdamW, apply_updates

Batch = Mapping[str, torch.Tensor]

# Logical axes of ``Model.loss``'s arguments.
BATCH_AXES = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
              "loss_mask": ("batch", "seq"),
              "enc_input": ("batch", None, "act_embed")}


def _check_params(model: Model, params: Mapping[str, torch.Tensor]) -> None:
    own = dict(model.named_parameters())
    if params.keys() != own.keys() or any(params[n] is not p
                                          for n, p in own.items()):
        raise ValueError("params must be dict(model.named_parameters()): "
                         "the step differentiates through the model")


def _take_grads(params: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return grads


def zero_constrain(grads: Dict[str, torch.Tensor],
                   grad_axes: Optional[Mapping[str, tuple]]
                   ) -> Dict[str, torch.Tensor]:
    """Each gradient constrained to its axes with the first replicated
    (``None`` or ``"embed"``) dimension replaced by ``"zero"``."""
    if grad_axes is None:
        return grads
    out = {}
    for name, g in grads.items():
        ax = list(grad_axes[name]) + [None] * (g.dim()
                                               - len(grad_axes[name]))
        for i, a in enumerate(ax):
            if a is None or a == "embed":
                ax[i] = "zero"
                break
        out[name] = constrain(g, *ax)
    return out


def make_train_step(model: Model, optimizer: AdamW,
                    grad_accum: int = 1,
                    grad_axes: Optional[Mapping[str, tuple]] = None
                    ) -> Callable:
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    {"loss", "nll", "moe_aux", "grad_norm", "lr"})``; ``batch`` holds
    ``Model.loss``'s arguments (tokens, targets, optional loss_mask and
    enc_input). It turns the model's gradients on.

    ``grad_accum > 1`` runs the batch as that many microbatches, one
    backward each: autograd sums their float32 gradients into ``.grad``,
    which is scaled by ``1/grad_accum`` once after the last (dividing
    each microbatch's gradient instead rounds every contribution when
    ``grad_accum`` is not a power of two). ``loss`` is then the mean of
    the microbatch losses, ``nll`` and ``moe_aux`` the last one's.
    ``grad_axes`` ZeRO-constrains the summed gradients once, before
    the optimizer (see ``zero_constrain``)."""
    model.requires_grad_(True)

    def train_step(params, opt_state, batch: Batch):
        _check_params(model, params)
        if grad_accum <= 1:
            loss, metrics = model.loss(**batch)
            with sharded_param_grads(params.values()):
                loss.backward()
        else:
            # under a mesh the batch is gathered, split and each
            # microbatch sharded again (its rows on every data rank)
            micro = {k: constrain(v).reshape(
                (grad_accum, v.shape[0] // grad_accum) + v.shape[1:])
                for k, v in batch.items()}
            loss = torch.zeros((), device=next(iter(params.values())).device)
            for i in range(grad_accum):
                mb_loss, metrics = model.loss(
                    **{k: constrain(v[i], *BATCH_AXES[k])
                       for k, v in micro.items()})
                with sharded_param_grads(params.values()):
                    mb_loss.backward()
                loss = loss + mb_loss.detach()
            inv = 1.0 / grad_accum
            with torch.no_grad():
                torch._foreach_mul_([p.grad for p in params.values()], inv)
            loss = loss * inv
        grads = zero_constrain(_take_grads(params), grad_axes)
        updates, opt_state, opt_metrics = optimizer.update(grads, opt_state,
                                                           params)
        del grads
        params = apply_updates(params, updates)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return params, opt_state, out

    return train_step


def make_grad_step(model: Model) -> Callable:
    """Gradient-only step ``(params, batch) -> (grads, {"loss", "nll",
    "moe_aux"})``, the gradients keyed by parameter name."""
    model.requires_grad_(True)

    def grad_step(params, batch: Batch):
        _check_params(model, params)
        loss, metrics = model.loss(**batch)
        with sharded_param_grads(params.values()):
            loss.backward()
        return _take_grads(params), {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}}

    return grad_step


def make_prefill_step(model: Model, max_seq: Optional[int] = None
                      ) -> Callable:
    """``(tokens[, enc_input]) -> (last logits, cache)``. The prefill
    and serve steps run under ``no_grad`` (not ``inference_mode``, in
    which ``DTensor`` parameters cannot be viewed)."""
    if model.cfg.encoder_layers:
        @torch.no_grad()
        def prefill_step(tokens, enc_input):
            return model.prefill(tokens, enc_input, max_seq=max_seq)
    else:
        @torch.no_grad()
        def prefill_step(tokens):
            return model.prefill(tokens, max_seq=max_seq)
    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One decode step: ``(cache, token, pos[, enc_out]) -> (logits,
    cache)``, the cache updated in place."""
    if model.cfg.encoder_layers:
        @torch.no_grad()
        def serve_step(cache, token, pos, enc_out):
            return model.decode_step(cache, token, pos, enc_out=enc_out)
    else:
        @torch.no_grad()
        def serve_step(cache, token, pos):
            return model.decode_step(cache, token, pos)
    return serve_step
