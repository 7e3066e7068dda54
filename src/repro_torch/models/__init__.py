"""The language models of the port (dense, MoE, RWKV, Mamba-hybrid and
encoder-decoder families), the PyTorch counterpart of ``repro.models``."""
