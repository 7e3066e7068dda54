"""The language-model decoders of the port (dense and MoE attention
families), the PyTorch counterpart of ``repro.models``."""
