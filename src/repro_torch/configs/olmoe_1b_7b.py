"""olmoe-1b-7b [moe]: 64 experts top-8, every layer MoE.

16L d_model=2048 16H (GQA kv=16) d_ff=1024(expert) vocab=50304
[arXiv:2409.02060]. ~7B total / ~1B active.
"""
from .base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    moe=MoESpec(num_experts=64, experts_per_token=8, d_ff_expert=1024,
                every_k_layers=1),
))
