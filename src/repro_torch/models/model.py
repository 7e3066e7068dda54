"""Public model API of the port: build any registered architecture from
its config (the PyTorch counterpart of ``repro.models.model``).

``Model`` serves and trains every family of the registry: decoder-only
stacks of attention, Mamba and RWKV blocks with dense, MoE or
channel-mix FFNs (dense, MoE, RWKV, the Jamba hybrid), and the
encoder-decoder (seamless-m4t). ``forward`` / ``hidden`` run a whole
sequence, ``loss`` is the training objective, ``prefill`` fills the
decode cache and unembeds only the last position, ``init_cache`` and
``decode_step`` decode one token at a time. An encoder-decoder takes
``enc_input``, precomputed frame embeddings (B, F, d): the modality
frontend is a stub in both packages.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from ..configs.base import ATTN, ArchConfig
from ..kernels.ops import resolve_device
from ..sharding.rules import constrain
from .layers import Attention, Embeddings, empty_param, init_parameters, \
    rms_norm
from .transformer import Block, Cache, Stack, remat

# Weight of the MoE load-balancing loss in the training objective.
MOE_AUX_COEF = 0.01


class Encoder(nn.Module):
    """``encoder_layers`` bidirectional attention blocks with dense FFNs
    and a final norm (``encoder.blocks.<i>.*``, ``encoder.norm_f``)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            Block(cfg, ATTN, False, i, dtype, device, causal=False)
            for i in range(cfg.encoder_layers))
        self.norm_f = empty_param(cfg.d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, _ = x.shape
        positions = torch.arange(f, device=x.device).expand(b, f)
        for block in self.blocks:
            x = remat(self.cfg.remat, lambda blk, x: blk(x, positions)[0],
                      block, x)
        return rms_norm(self.norm_f, x, self.cfg.norm_eps)


class CrossBlock(nn.Module):
    """One decoder layer's cross-attention: ``x + attn.cross(norm(x),
    enc_out)`` (``cross.<i>.attn.*``, ``cross.<i>.norm``)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.attn = Attention(cfg, dtype, device, causal=False)
        self.norm = empty_param(cfg.d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        return x + self.attn.cross(rms_norm(self.norm, x, self.eps), enc_out)


def _layer_with_cross(block: Block, cross: CrossBlock, x: torch.Tensor,
                      positions: torch.Tensor, enc_out: torch.Tensor):
    x, aux = block(x, positions)
    return cross(x, enc_out), aux


class Model(nn.Module):
    """Embeddings, the block stack and the final norm (and, for an
    encoder-decoder, the encoder and per-layer cross-attention), with
    parameters named as the reference's pytree (``embed.tok``,
    ``stack.layers.<i>.mixer.wq``, ``norm_f``, ``encoder.blocks.<i>.*``,
    ``cross.<i>.attn.wq``, ...). Parameters are left uninitialised:
    ``build_model`` draws them, ``convert.params_from_numpy`` copies
    them."""

    # sequence-chunked cross-entropy: the float32 logits live as
    # (B, CE_CHUNK, V) at a time instead of (B, S, V)
    CE_CHUNK = 512

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = Embeddings(cfg, dtype, device)
        self.stack = Stack(cfg, dtype, device)
        self.norm_f = empty_param(cfg.d_model, dtype=dtype, device=device)
        if cfg.encoder_layers:
            if len(cfg.block_pattern) != 1 or cfg.layer_kinds()[0] != ATTN:
                raise ValueError(f"{cfg.name}: an encoder-decoder needs a "
                                 "decoder of attention blocks, period 1")
            self.encoder = Encoder(cfg, dtype, device)
            self.cross = nn.ModuleList(CrossBlock(cfg, dtype, device)
                                       for _ in range(cfg.num_layers))

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        return torch.arange(s, device=tokens.device).expand(b, s)

    def _enc_out(self, enc_input: Optional[torch.Tensor]) -> torch.Tensor:
        if enc_input is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder model "
                             "needs enc_input")
        return self.encode(enc_input)

    def encode(self, enc_input: torch.Tensor) -> torch.Tensor:
        """enc_input (B, F, d) -> the encoder's output (B, F, d)."""
        return self.encoder(enc_input.to(self.norm_f.dtype))

    def hidden(self, tokens: torch.Tensor,
               enc_input: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> (final hidden states (B,S,d), moe_aux)."""
        x = constrain(self.embed(tokens), "batch", "seq", "act_embed")
        positions = self._positions(tokens)
        if self.cfg.encoder_layers:
            enc_out = self._enc_out(enc_input)
            aux = torch.zeros((), device=x.device)
            for block, cross in zip(self.stack.layers, self.cross,
                                    strict=True):
                x, a = remat(self.cfg.remat, _layer_with_cross, block,
                             cross, x, positions, enc_out)
                if a is not None:
                    aux = aux + a
        else:
            x, aux = self.stack(x, positions)
        return rms_norm(self.norm_f, x, self.cfg.norm_eps), aux

    def forward(self, tokens: torch.Tensor,
                enc_input: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B,S) -> (logits (B,S,V), moe_aux)."""
        x, aux = self.hidden(tokens, enc_input)
        logits = constrain(self.embed.unembed(x), "batch", "seq", "vocab")
        return logits, aux

    # -- loss ------------------------------------------------------------------

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None,
             enc_input: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy plus ``MOE_AUX_COEF`` x the MoE aux
        loss. tokens, targets, loss_mask (B,S). Returns ``(loss,
        {"nll", "moe_aux"})``; ``nll`` is the masked mean, the sum of
        ``nll * mask`` over ``max(sum(mask), 1)``, log-softmax in float32.

        The logits are formed CE_CHUNK positions at a time when S is a
        multiple of it, else whole. The loss runs through ``hidden``,
        never ``prefill``, which writes its cache in place."""
        x, aux = self.hidden(tokens, enc_input)
        b, s, _ = x.shape
        mask = (torch.ones((b, s), device=x.device) if loss_mask is None
                else loss_mask.float())
        chunk = self.CE_CHUNK if s % self.CE_CHUNK == 0 else s

        def ce(lo):
            logits = constrain(self.embed.unembed(x[:, lo:lo + chunk]),
                               "batch", "seq", "vocab")
            logp = F.log_softmax(logits.float(), dim=-1)
            tgt = targets[:, lo:lo + chunk, None].long()
            if isinstance(logp, DTensor):
                # a gather's backward scatters into zeros that DTensor
                # makes whole on every rank (the global batch's logits);
                # a one-hot product keeps the rows sharded
                hit = tgt == torch.arange(logp.shape[-1], device=x.device)
                nll = -(logp * hit).sum(-1)
            else:
                nll = -torch.gather(logp, -1, tgt)[..., 0]
            return (nll * mask[:, lo:lo + chunk]).sum()

        total = ce(0)
        for lo in range(chunk, s, chunk):
            total = total + ce(lo)
        loss = total / torch.clamp(mask.sum(), min=1.0)
        return loss + MOE_AUX_COEF * aux, {"nll": loss, "moe_aux": aux}

    # -- serving -----------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """Zeroed decode state for every layer, on the parameters' device
        and in their dtype (the recurrent states in float32)."""
        return self.stack.init_cache(batch, max_seq, self.norm_f.dtype,
                                     self.norm_f.device)

    def prefill(self, tokens: torch.Tensor,
                enc_input: Optional[torch.Tensor] = None,
                max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """Process the prompt and build the decode cache in one pass.

        Returns (last-position logits (B,1,V), cache). Only the last
        position is unembedded: a (B,S,V) logits tensor at long prefill
        would dwarf every other buffer."""
        b, s = tokens.shape
        cache = self.init_cache(b, max_seq or s)
        x = constrain(self.embed(tokens), "batch", "seq", "act_embed")
        positions = self._positions(tokens)
        if self.cfg.encoder_layers:
            enc_out = self._enc_out(enc_input)
            for block, cross in zip(self.stack.layers, self.cross,
                                    strict=True):
                x, _ = block(x, positions, cache)
                x = cross(x, enc_out)
        else:
            x = self.stack.prefill(x, positions, cache)
        x_last = rms_norm(self.norm_f, x[:, -1:], self.cfg.norm_eps)
        return self.embed.unembed(x_last), cache

    def decode_step(self, cache: Cache, token: torch.Tensor, pos: int,
                    enc_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (B,1), pos the position it takes -> (logits (B,1,V),
        cache), the cache updated in place. An encoder-decoder takes the
        encoder's output ``enc_out`` (``encode(enc_input)``)."""
        x = constrain(self.embed(token), "batch", None, "act_embed")
        if self.cfg.encoder_layers:
            if enc_out is None:
                raise ValueError(f"{self.cfg.name}: decoding an "
                                 "encoder-decoder model needs enc_out")
            for block, cross in zip(self.stack.layers, self.cross,
                                    strict=True):
                x = cross(block.decode(x, cache, pos), enc_out)
        else:
            x = self.stack.decode(x, cache, pos)
        x = rms_norm(self.norm_f, x, self.cfg.norm_eps)
        return self.embed.unembed(x), cache


def build_model(cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                device: Optional[str] = None,
                generator: Optional[torch.Generator] = None) -> Model:
    """A model with random parameters drawn from ``generator`` (seed 0
    on ``device`` when none is given), frozen (``requires_grad`` off:
    the train steps of ``launch.steps`` turn it on).

    ``device=None`` means CUDA and raises when no CUDA device is present;
    ``device="cpu"`` runs on the CPU."""
    dev = resolve_device(device)
    model = Model(cfg, dtype, dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    init_parameters(model, generator)
    return model.eval()
