"""codeqwen1.5-7b [dense]: qwen1.5 architecture (MHA: kv == heads).

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B].
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
))
