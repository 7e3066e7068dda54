"""Hand-written CUDA kernels for the brTPF hot spots, with their plain
PyTorch versions.

``bindjoin``  -- server-side bindings-restricted filter (Definition 1),
                 ungrouped, grouped and fused (``csrc/bindjoin.cu``)
``tpf_match`` -- single-triple-pattern matcher (``csrc/tpf_match.cu``)

``ref.py`` holds the plain oracles, ``build.py`` compiles and loads the
CUDA sources at first use, and ``ops.py`` the padded public entry points
(a CUDA tensor launches the kernel, a CPU tensor runs the plain version).
"""
from .ops import (bindjoin, bindjoin_fused, bindjoin_grouped, compact_mask,
                  pattern_vec_from, tpf_match)

__all__ = ["bindjoin", "bindjoin_fused", "bindjoin_grouped", "compact_mask",
           "pattern_vec_from", "tpf_match"]
