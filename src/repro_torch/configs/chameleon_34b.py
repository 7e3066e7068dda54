"""chameleon-34b [vlm]: early-fusion multimodal decoder, VQ image tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818]. Early fusion means image tokens are ordinary vocab
entries (VQ codes); the VQ tokenizer frontend is a stub per the brief --
``input_specs()`` provides token ids directly.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    frontend_stub=True,
    rope=True,
))
