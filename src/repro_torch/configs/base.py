"""Architecture + shape configuration system (the port's copy of
``repro.configs.base``, pure Python, unchanged).

Every assigned architecture is a frozen ``ArchConfig``; every workload
shape is a ``ShapeSpec``. The fields that only the JAX package reads
(``remat``, ``sharding_overrides``) are kept so that one config value
means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

# Block kinds for the per-layer pattern of hybrid models.
ATTN = "attn"
MAMBA = "mamba"
RWKV = "rwkv"


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    every_k_layers: int = 1        # MoE FFN on layers where i % k == k-1
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int                      # dense FFN width (expert width in MoESpec)
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    moe: Optional[MoESpec] = None
    # per-layer block pattern, tiled to num_layers ('attn' default)
    block_pattern: Tuple[str, ...] = (ATTN,)
    # encoder-decoder (0 = decoder-only)
    encoder_layers: int = 0
    # embedding frontends for [vlm]/[audio] are stubs per the brief
    frontend_stub: bool = False
    rope: bool = True
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # SSM (mamba) dims
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    # RWKV dims
    rwkv_head_dim: int = 64
    # scan chunk for linear-recurrence blocks
    chunk_size: int = 128
    # remat policy for scan-over-layers: 'none' | 'full' | 'dots'
    remat: str = "full"
    # MoE dispatch family: 'einsum' (GShard one-hot) | 'gather' (sort +
    # scatter-add; zero dispatch FLOPs -- the beyond-paper SPerf variant)
    moe_dispatch: str = "einsum"
    # per-arch logical->mesh rule overrides, e.g. FSDP param sharding:
    # (("embed", "data"),) shards every param's embed dim over data and
    # GSPMD all-gathers each layer's weights inside the scan (ZeRO-3)
    sharding_overrides: Tuple[Tuple[str, Any], ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    @property
    def is_attention_free(self) -> bool:
        return all(k != ATTN for k in self.layer_kinds())

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: any SSM/linear-recurrence layers."""
        return any(k in (MAMBA, RWKV) for k in self.layer_kinds())

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        k = self.moe.every_k_layers
        return i % k == k - 1

    # -- parameter counting (for 6*N*D roofline terms) -----------------------

    def param_count(self, active_only: bool = False) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        total = 0
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            if kind == ATTN:
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
            elif kind == MAMBA:
                din = self.ssm_expand * d
                total += (d * 2 * din              # in_proj (x and gate)
                          + din * self.ssm_conv_dim
                          + din * (2 * self.ssm_state_dim + 1)  # B,C,dt proj
                          + din                    # A (per-channel) + dt bias
                          + din * d)               # out_proj
            elif kind == RWKV:
                # time-mix: r,k,v,g,o projections + decay lora
                total += 5 * d * d + 2 * d * 64
                # channel-mix: W_k (d,ff), W_v (ff,d), W_r (d,d)
                total += 2 * d * ff + d * d
                total += 2 * d
                continue  # RWKV has its own FFN (channel mix)
            # FFN
            if self.is_moe_layer(i):
                m = self.moe
                total += m.num_experts * 3 * d * m.d_ff_expert
                total += d * m.num_experts       # router
            else:
                total += 3 * d * ff
            total += 2 * d                        # norms
        total += v * d                            # embed in
        if not self.tie_embeddings:
            total += v * d                        # lm head
        if self.encoder_layers:
            # encoder stack (self-attn + ffn) + decoder cross-attn
            enc = self.encoder_layers * (
                (2 + 2) * d * self.num_heads * hd + 3 * d * ff + 2 * d)
            xattn = self.num_layers * (
                (2 + 2) * d * self.num_heads * hd + d)
            total += enc + xattn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        n_moe = sum(1 for i in range(self.num_layers)
                    if self.is_moe_layer(i))
        inactive = n_moe * (m.num_experts - m.experts_per_token) * (
            3 * d * m.d_ff_expert)
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                     LONG_500K)


def shapes_for(cfg: ArchConfig) -> Tuple[ShapeSpec, ...]:
    """The runnable shape set for an arch (skips recorded in the table)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)


def skipped_shapes_for(cfg: ArchConfig) -> Tuple[Tuple[ShapeSpec, str], ...]:
    if not cfg.supports_long_context:
        return ((LONG_500K, "full attention (quadratic); per-brief skip"),)
    return ()


# Registry -- populated by the per-arch config modules.
_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    from . import (chameleon_34b, chatglm3_6b, codeqwen15_7b,  # noqa: F401
                   granite_moe_1b_a400m, jamba_15_large_398b,
                   olmoe_1b_7b, phi4_mini_38b, qwen2_15b, rwkv6_7b,
                   seamless_m4t_medium)


def reduced_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Same family, tiny dims: used by the per-arch CPU smoke tests.

    Preserves what makes the family distinctive (GQA ratio, MoE routing,
    block pattern period, enc-dec split) while shrinking width/depth."""
    kv_ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = 4
    moe = None
    if cfg.moe is not None:
        # capacity_factor = num_experts -> capacity == T*k: provably no
        # token drops, so decode-vs-forward equality holds exactly in the
        # numerics tests (production configs keep the real 1.25).
        moe = MoESpec(num_experts=4,
                      experts_per_token=min(2, cfg.moe.experts_per_token),
                      d_ff_expert=64,
                      every_k_layers=cfg.moe.every_k_layers,
                      capacity_factor=4.0)
    pattern = cfg.block_pattern
    layers = max(2, len(pattern)) if len(pattern) > 1 else 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=64,
        num_heads=heads if cfg.num_heads else 0,
        num_kv_heads=max(1, heads // kv_ratio) if cfg.num_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128,
        vocab_size=256,
        moe=moe,
        encoder_layers=2 if cfg.encoder_layers else 0,
        ssm_state_dim=8,
        rwkv_head_dim=16,
        chunk_size=8,
    )
