"""seamless-m4t-medium [audio]: encoder-decoder, multimodal.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596]. 12 encoder + 12 decoder layers; the speech frontend
is a stub per the brief: ``input_specs()`` provides precomputed frame
embeddings (B, frames, d_model) to the encoder. Decode shapes run the
autoregressive text decoder with cross-attention to the encoder output.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    encoder_layers=12,
    frontend_stub=True,
    rope=False,          # learned/sinusoidal positions in the original
))
