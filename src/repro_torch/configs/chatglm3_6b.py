"""chatglm3-6b [dense]: RoPE (2d/half-rotary), GQA kv=2.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
[arXiv:2406.12793]. ChatGLM applies rotary embeddings to half the head
dims ("2d RoPE"); we implement standard full-dim RoPE -- an FLOP-neutral
simplification recorded in DESIGN.md.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
))
