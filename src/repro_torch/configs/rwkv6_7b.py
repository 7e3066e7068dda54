"""rwkv6-7b [ssm]: Finch -- attention-free, data-dependent decay.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 [arXiv:2404.05892].
Linear recurrence with per-channel data-dependent decay (WKV6); runs the
long_500k shape (constant-size recurrent state instead of a KV cache).
"""
from .base import ArchConfig, RWKV, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=(RWKV,),
    rope=False,
    rwkv_head_dim=64,
    # chunked WKV materializes a (B, C, C, H, hd) pairwise-decay tensor;
    # C=16 keeps it ~0.4 GB/device at train_4k (C=128 would be ~100 GB)
    chunk_size=16,
))
