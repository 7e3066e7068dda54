"""Single-triple-pattern matcher (the TPF selector's base mask).

The hand-written CUDA kernel is ``csrc/tpf_match.cu``. It replaces the
TPU kernel ``repro/kernels/tpf_match.py:tpf_match_pallas``. On the card
it is bound by bytes (16 per row against about a dozen integer
operations), so it is one coalesced pass, one thread per row, that masks
its own ragged edge.

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


def tpf_match_plain(cand_s, cand_p, cand_o, pattern_vec) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int32 [T] mask (1 = match)."""
    return ref.tpf_match_ref(cand_s, cand_p, cand_o,
                             pattern_vec).to(torch.int32)


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor")
    if tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: shape {tuple(x.shape)} on {x.device}, "
                         f"expected {tuple(shape)} on {device}")


def tpf_match_cuda(cand_s: torch.Tensor, cand_p: torch.Tensor,
                   cand_o: torch.Tensor,
                   pattern_vec: torch.Tensor) -> torch.Tensor:
    """Match one pattern vector ``[s, p, o, eq_sp, eq_so, eq_po, 0, 0]``
    against T candidate triples given as int32 ``[T]`` components.
    Returns the int32 ``[T]`` mask (1 = match)."""
    if cand_s.device.type == "cpu":
        return tpf_match_plain(cand_s, cand_p, cand_o, pattern_vec)
    if cand_s.device.type != "cuda":
        raise ValueError(f"tpf_match: unsupported device {cand_s.device}")
    t = cand_s.shape[0]
    for name, x in (("cand_s", cand_s), ("cand_p", cand_p),
                    ("cand_o", cand_o)):
        _check(name, x, (t,), cand_s.device)
    _check("pattern_vec", pattern_vec, (8,), cand_s.device)
    mask = torch.empty((t,), dtype=torch.int32, device=cand_s.device)
    lib = build.library("tpf_match")
    err = lib.brtpf_tpf_match(
        cand_s.data_ptr(), cand_p.data_ptr(), cand_o.data_ptr(),
        pattern_vec.data_ptr(), mask.data_ptr(), t,
        torch.cuda.current_stream(cand_s.device).cuda_stream)
    build.check(err, "tpf_match")
    tpf_match_cuda.launches += 1
    tpf_match_cuda.shapes[(t,)] += 1
    return mask


tpf_match_cuda.launches = 0
tpf_match_cuda.shapes = Counter()
