"""granite-moe-1b-a400m [moe]: 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512(expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from .base import ArchConfig, MoESpec, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoESpec(num_experts=32, experts_per_token=8, d_ff_expert=512,
                every_k_layers=1),
))
