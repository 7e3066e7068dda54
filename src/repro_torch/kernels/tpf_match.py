"""Single-triple-pattern matcher (the full-shard stream's base mask).

The hand-written CUDA kernel is ``csrc/tpf_match.cu``. It replaces the
TPU kernel ``repro/kernels/tpf_match.py:tpf_match_pallas``. On the card
it is bound by bytes (13 per row against about a dozen integer
operations), so it is one pass, one thread per row of the AoS
``[T, 3]`` block as it lies, that masks its own ragged edge and writes a
uint8 mask. Only ``FederatedStore.execute_full`` and its steps launch it:
the grouped steps run the same test in the grouped bind-join kernel's
prologue.

:func:`tpf_match_cuda` dispatches on the tensor's device: a CUDA tensor
launches the kernel (and counts the launch in ``tpf_match_cuda.launches``,
and its row count T in the ``tpf_match_cuda.shapes`` tally), a CPU tensor
takes :func:`tpf_match_plain`. There is no fallback: a
CUDA launch that fails raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import build, ref


def tpf_match_plain(cand, pattern_vec) -> torch.Tensor:
    """Plain PyTorch version of the kernel: uint8 [T] mask (1 = match)."""
    return ref.tpf_match_ref(cand[:, 0], cand[:, 1], cand[:, 2],
                             pattern_vec).to(torch.uint8)


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor")
    if tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, "
                         f"expected {tuple(shape)} on {device}")


def tpf_match_cuda(cand: torch.Tensor,
                   pattern_vec: torch.Tensor) -> torch.Tensor:
    """Match one pattern vector ``[s, p, o, eq_sp, eq_so, eq_po, 0, 0]``
    against the int32 ``[T, 3]`` candidate triples. Returns the uint8
    ``[T]`` mask (1 = match)."""
    if cand.device.type == "cpu":
        return tpf_match_plain(cand, pattern_vec)
    if cand.device.type != "cuda":
        raise ValueError(f"tpf_match: unsupported device {cand.device}")
    t = cand.shape[0]
    _check("cand", cand, (t, 3), cand.device)
    _check("pattern_vec", pattern_vec, (8,), cand.device)
    mask = torch.empty((t,), dtype=torch.uint8, device=cand.device)
    if t == 0:
        return mask
    lib = build.library("tpf_match")
    err = lib.brtpf_tpf_match(
        cand.data_ptr(), pattern_vec.data_ptr(), mask.data_ptr(), t,
        torch.cuda.current_stream(cand.device).cuda_stream)
    build.check(err, "tpf_match")
    tpf_match_cuda.launches += 1
    tpf_match_cuda.shapes[(t,)] += 1
    return mask


tpf_match_cuda.launches = 0
tpf_match_cuda.shapes = Counter()
