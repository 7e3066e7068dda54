"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE every other
layer [arXiv:2403.19887]. Block period of 8: one attention layer per 7
Mamba layers (attention at period index 4, as in the Jamba paper); MoE
FFN on odd layers. Runs long_500k (only its 9 attention layers carry a
KV cache; the 63 Mamba layers keep constant-size state).
"""
from .base import ATTN, ArchConfig, MAMBA, MoESpec, register

_PERIOD = (MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA)

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    moe=MoESpec(num_experts=16, experts_per_token=2, d_ff_expert=24576,
                every_k_layers=2),
    block_pattern=_PERIOD,
    rope=False,          # Jamba uses no positional embeddings
    ssm_state_dim=16,
    ssm_expand=2,
    # 398B bf16 over model=16 alone is ~50 GB/chip; FSDP-shard the
    # params' embed dims over data too (ZeRO-3 via GSPMD): ~3.1 GB/chip,
    # with per-layer weight all-gathers inside the scan
    sharding_overrides=(("embed", "data"),),
))
