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
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.nn import functional as F

from ..configs.base import ATTN, ArchConfig
from ..kernels.ops import resolve_device
from ..sharding.rules import constrain, local_inputs
from .layers import Attention, Embeddings, empty_param, init_parameters, \
    rms_norm
from .transformer import Block, Cache, Stack, normed, remat, residual

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
        positions = positions_like(x)
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
        return residual(x, self.attn.cross(normed(self.norm, x, self.eps),
                                           enc_out))


def positions_like(x: torch.Tensor) -> torch.Tensor:
    """Positions ``0 .. S-1`` of every row of ``x (B, S, ...)`` as a
    ``(B, S)`` tensor. For a ``DTensor``, one placed as ``x``'s rows
    (each rank holds its own rows' positions): a plain tensor would be
    the global batch's on every rank, and so would the RoPE angles
    formed from it."""
    b, s = x.shape[:2]
    if not isinstance(x, DTensor):
        return torch.arange(s, device=x.device).expand(b, s)
    pl = [p if p.is_shard(0) else Replicate() for p in x.placements]
    local = x.to_local()
    rows = torch.arange(s, device=local.device).expand(local.shape[0], s)
    return DTensor.from_local(rows.contiguous(), x.device_mesh, pl,
                              run_check=False, shape=torch.Size((b, s)),
                              stride=(s, 1))


def _layer_with_cross(block: Block, cross: CrossBlock, x: torch.Tensor,
                      positions: torch.Tensor, enc_out: torch.Tensor):
    x, aux = block(x, positions)
    return cross(x, enc_out), aux


class _VocabParallelNLL(torch.autograd.Function):
    """``-log_softmax(x)[t]`` of float32 logits ``x (B, S, Vl)``, one
    rank's shard of the vocabulary (its rows ``lo .. lo + Vl``), for
    targets ``t (B, S)`` anywhere in the vocabulary (Megatron's
    vocab-parallel cross-entropy). ``group`` is the process group that
    splits the vocabulary, ``None`` when it is whole: the max is reduced
    over it, and the sum of exponentials with the target's logit (zero
    on every rank but its owner's) in one all-reduce.

    ``x - max`` is float32, as in ``F.log_softmax``; the exponentials
    and their sum are float64, and the backward, ``(softmax -
    one_hot(t)) * grad``, forms the softmax in float64 and rounds once:
    the ranks' partial sums then meet without a float32 rounding that
    depends on how many ranks split the vocabulary. Saves the shard's
    ``x - max`` (float32); the backward needs no collective."""

    @staticmethod
    def forward(ctx, x, tgt, lo, group):
        rows = x.shape[-1]
        m = x.amax(-1)
        if group is not None:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", group))
        z = x - m[..., None]
        idx = tgt.long() - lo
        inside = (idx >= 0) & (idx < rows)
        idx = idx.clamp(0, rows - 1)
        picked = torch.gather(z, -1, idx[..., None])[..., 0] * inside
        sums = torch.stack([z.double().exp_().sum(-1), picked.double()])
        if group is not None:
            sums = funcol.wait_tensor(funcol.all_reduce(sums, "sum", group))
        lse = torch.log(sums[0])
        ctx.save_for_backward(z, lse, idx, inside)
        return (lse - sums[1]).float()

    @staticmethod
    def backward(ctx, grad):
        z, lse, idx, inside = ctx.saved_tensors
        grad = grad.double()
        dx = z.double().sub_(lse[..., None]).exp_().mul_(grad[..., None])
        dx.scatter_add_(-1, idx[..., None], -(grad * inside)[..., None])
        return dx.float(), None, None, None


def vocab_parallel_nll(logits: DTensor, targets: torch.Tensor) -> DTensor:
    """Per-position NLL ``(B, S)`` of float32 logits ``(B, S, V)`` whose
    vocabulary is sharded over the model axis, without gathering it:
    each rank reduces its own vocabulary shard (``_VocabParallelNLL``),
    as ``layers._sharded_lookup`` looks up its own rows. The rows keep
    the logits' batch and sequence placements; the NLL is replicated
    over the model axis, and the logits' gradient comes back sharded as
    they are."""
    mesh = logits.device_mesh
    mi = mesh.mesh_dim_names.index("model")
    pl = list(logits.placements)
    vocab_sharded = pl[mi].is_shard(2)
    if any(p.is_shard(2) for i, p in enumerate(pl) if i != mi):
        raise ValueError(f"the vocabulary is split over more than the "
                         f"model axis: {pl}")
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    t_pl = [Replicate() if p.is_shard(2) else p for p in pl]
    group = mesh.get_group(mi) if vocab_sharded else None

    def nll(x, tgt):
        lo = mesh.get_local_rank("model") * x.shape[-1] if vocab_sharded \
            else 0
        return _VocabParallelNLL.apply(x, tgt, lo, group)

    return local_map(local_inputs(nll), out_placements=t_pl,
                     in_placements=(pl, t_pl), in_grad_placements=(pl, t_pl),
                     device_mesh=mesh, redistribute_inputs=True)(logits,
                                                                 targets)


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
        positions = positions_like(tokens)
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
        return normed(self.norm_f, x, self.cfg.norm_eps), aux

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
                               "batch", "seq", "vocab").float()
            tgt = targets[:, lo:lo + chunk]
            if isinstance(logits, DTensor):
                nll = vocab_parallel_nll(logits, tgt)
            else:
                logp = F.log_softmax(logits, dim=-1)
                nll = -torch.gather(logp, -1, tgt[..., None].long())[..., 0]
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
        positions = positions_like(tokens)
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
