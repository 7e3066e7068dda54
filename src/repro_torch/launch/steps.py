"""Train, gradient, prefill and serve steps for every architecture (the
PyTorch counterpart of ``repro.launch.steps``).

The reference's steps are pure functions of ``params`` that its
launchers jit and shard. Here the model owns its parameters: a step
takes ``params`` as ``dict(model.named_parameters())`` (the model's own
tensors, checked), runs autograd through the model, and updates the
parameters and the optimizer state in place, as the reference's
launchers donate them. The prefill and serve steps take no ``params``.

The reference's ``grad_axes`` (ZeRO-sharding the gradient accumulator
over the data axis of a mesh, through ``sharding.rules.constrain``) is
mesh-only and is dropped with the rest of the sharding layer
(ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ..models.model import Model
from ..train.optimizer import AdamW, apply_updates

Batch = Mapping[str, torch.Tensor]


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


def make_train_step(model: Model, optimizer: AdamW,
                    grad_accum: int = 1) -> Callable:
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    {"loss", "nll", "moe_aux", "grad_norm", "lr"})``; ``batch`` holds
    ``Model.loss``'s arguments (tokens, targets, optional loss_mask and
    enc_input). It turns the model's gradients on.

    ``grad_accum > 1`` runs the batch as that many microbatches, one
    backward each: autograd sums their float32 gradients into ``.grad``,
    which is scaled by ``1/grad_accum`` once after the last (dividing
    each microbatch's gradient instead rounds every contribution when
    ``grad_accum`` is not a power of two). ``loss`` is then the mean of
    the microbatch losses, ``nll`` and ``moe_aux`` the last one's."""
    model.requires_grad_(True)

    def train_step(params, opt_state, batch: Batch):
        _check_params(model, params)
        if grad_accum <= 1:
            loss, metrics = model.loss(**batch)
            loss.backward()
        else:
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + v.shape[1:]) for k, v in batch.items()}
            loss = torch.zeros((), device=next(iter(params.values())).device)
            for i in range(grad_accum):
                mb_loss, metrics = model.loss(
                    **{k: v[i] for k, v in micro.items()})
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            inv = 1.0 / grad_accum
            with torch.no_grad():
                torch._foreach_mul_([p.grad for p in params.values()], inv)
            loss = loss * inv
        grads = _take_grads(params)
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
        loss.backward()
        return _take_grads(params), {
            "loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}}

    return grad_step


def make_prefill_step(model: Model, max_seq: Optional[int] = None
                      ) -> Callable:
    """``(tokens[, enc_input]) -> (last logits, cache)``."""
    if model.cfg.encoder_layers:
        @torch.inference_mode()
        def prefill_step(tokens, enc_input):
            return model.prefill(tokens, enc_input, max_seq=max_seq)
    else:
        @torch.inference_mode()
        def prefill_step(tokens):
            return model.prefill(tokens, max_seq=max_seq)
    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One decode step: ``(cache, token, pos[, enc_out]) -> (logits,
    cache)``, the cache updated in place."""
    if model.cfg.encoder_layers:
        @torch.inference_mode()
        def serve_step(cache, token, pos, enc_out):
            return model.decode_step(cache, token, pos, enc_out=enc_out)
    else:
        @torch.inference_mode()
        def serve_step(cache, token, pos):
            return model.decode_step(cache, token, pos)
    return serve_step
