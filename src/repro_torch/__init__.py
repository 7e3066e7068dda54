"""repro_torch: the brTPF (Bindings-Restricted Triple Pattern Fragments)
server and clients ported from JAX on a TPU to PyTorch on an NVIDIA H100,
with hand-written CUDA kernels for the bind-join and the triple-pattern
matcher. The JAX package ``repro`` stays as the reference."""
__version__ = "0.1.0"
