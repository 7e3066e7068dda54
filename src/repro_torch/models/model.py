"""Public model API of the port: build a decoder from its config (the
PyTorch counterpart of ``repro.models.model``).

``Model`` serves the decoder-only attention families, dense and MoE:
``forward`` / ``hidden`` over a whole sequence, ``prefill`` (which fills
the KV cache and unembeds only the last position), ``init_cache`` and
``decode_step``. The Mamba, RWKV and encoder-decoder families are not
ported yet: building one raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ATTN, ArchConfig
from ..kernels.ops import resolve_device
from .layers import Embeddings, empty_param, init_parameters, rms_norm
from .transformer import Cache, Stack

# Where the families this slice does not serve are queued.
NOT_PORTED = ("not ported yet (ROADMAP Queue 1 item 1: the training "
              "slice, with the Mamba, RWKV and encoder-decoder families)")


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks."""
    kinds = sorted(set(cfg.layer_kinds()) - {ATTN})
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: {'/'.join(kinds)} blocks are {NOT_PORTED}")
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is {NOT_PORTED}")


class Model(nn.Module):
    """Embeddings, the block stack and the final norm, with parameters
    named as the reference's pytree (``embed.tok``, ``stack.layers.<i>.
    mixer.wq``, ``norm_f``, ...). Parameters are left uninitialised:
    ``build_model`` draws them, ``convert.params_from_numpy`` copies
    them."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = Embeddings(cfg, dtype, device)
        self.stack = Stack(cfg, dtype, device)
        self.norm_f = empty_param(cfg.d_model, dtype=dtype, device=device)

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        return torch.arange(s, device=tokens.device).expand(b, s)

    def hidden(self, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> (final hidden states (B,S,d), moe_aux)."""
        x = self.embed(tokens)
        x, aux = self.stack(x, self._positions(tokens))
        return rms_norm(self.norm_f, x, self.cfg.norm_eps), aux

    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> (logits (B,S,V), moe_aux)."""
        x, aux = self.hidden(tokens)
        return self.embed.unembed(x), aux

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """Zeroed K/V for every layer, on the parameters' device and in
        their dtype."""
        return self.stack.init_cache(batch, max_seq, self.norm_f.dtype,
                                     self.norm_f.device)

    def prefill(self, tokens: torch.Tensor, max_seq: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Process the prompt and build the decode cache in one pass.

        Returns (last-position logits (B,1,V), cache). Only the last
        position is unembedded: a (B,S,V) logits tensor at long prefill
        would dwarf every other buffer."""
        b, s = tokens.shape
        cache = self.init_cache(b, max_seq or s)
        x = self.stack.prefill(self.embed(tokens), self._positions(tokens),
                               cache)
        x_last = rms_norm(self.norm_f, x[:, -1:], self.cfg.norm_eps)
        return self.embed.unembed(x_last), cache

    def decode_step(self, cache: Cache, token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Cache]:
        """token (B,1), pos the position it takes -> (logits (B,1,V),
        cache), the cache updated in place."""
        x = self.stack.decode(self.embed(token), cache, pos)
        x = rms_norm(self.norm_f, x, self.cfg.norm_eps)
        return self.embed.unembed(x), cache


def build_model(cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                device: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> Model:
    """A model with random parameters drawn from ``generator`` (seed 0
    on ``device`` when none is given).

    ``device=None`` means CUDA and raises when no CUDA device is present;
    ``device="cpu"`` runs on the CPU."""
    dev = resolve_device(device)
    model = Model(cfg, dtype, dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    init_parameters(model, generator)
    return model.eval()
