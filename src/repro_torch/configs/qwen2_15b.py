"""qwen2-1.5b [dense]: GQA kv=2, QKV bias, tied embeddings.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2407.10671]. head_dim=128 (12*128=1536).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
))
