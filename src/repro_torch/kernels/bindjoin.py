"""Ungrouped, grouped and fused bind-join filters (the brTPF server's hot
spot).

The hand-written CUDA kernels are in ``csrc/bindjoin.cu``. They replace
the TPU kernels ``repro/kernels/bindjoin.py:bindjoin_pallas``,
``:bindjoin_grouped_pallas`` and ``:bindjoin_fused_pallas``. For every
candidate row and request group g the grouped and fused kernels compute
``keep`` (the row matches a valid slot of g), ``idx`` (the smallest
matching slot, or Mp when none) and ``nmatch`` (the number of matching
valid slots: the row's share of the Definition-2 ``cnt``), each int32
``[T, G]``. The ungrouped kernel (the sharded backend's full-shard
stream) computes ``keep`` and ``idx`` int32 ``[T]`` against one slot set,
with ``idx`` = the padded M where no slot matches.

On the card all three are bound by integer operations: every (row, slot)
cell costs a few compares while the candidate and output bytes are
touched once. One thread per row keeps any / min / count in registers
while the block stages its group's slots through shared memory tile by
tile; the fused kernel stages only its tile's own segment's slots (the
whole table can exceed one block's shared memory) and skips dead tiles.

Each ``*_cuda`` wrapper dispatches on the tensor's device: a CUDA tensor
launches the kernel (counted in the wrapper's ``launches``), a CPU
tensor takes the ``*_plain`` version. There is no fallback: a CUDA launch
that fails raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import build, ref

DEFAULT_BT = 1024
DEFAULT_BM = 128

# Fused launches tile the candidate stream finer than the same-pattern
# grouped kernel: each segment's block is tile-aligned independently, so
# a smaller tile bounds the per-segment alignment waste. The CUDA kernel
# runs one 256-thread block per tile, so this is also its block size.
DEFAULT_FUSED_BT = 256

# The plain versions build a [rows, G, Mp] compare grid; they walk the
# rows in chunks so that the grid stays near this many cells.
PLAIN_CHUNK_CELLS = 1 << 26


def _row_chunks(t: int, cells_per_row: int):
    """Row ranges of the plain versions' chunks (one, empty, if t == 0)."""
    step = max(1, PLAIN_CHUNK_CELLS // max(cells_per_row, 1))
    for lo in range(0, max(t, 1), step):
        yield lo, min(lo + step, t)


def _int32_outputs(keep, idx, nmatch):
    return keep.to(torch.int32), idx, nmatch


def bindjoin_plain(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o, pat_valid):
    """Plain PyTorch version of the ungrouped kernel, same flat inputs
    (``pat_*`` int32 ``[M]``) and int32 ``[T]`` outputs (keep, idx)."""
    parts = [(keep.to(torch.int32), idx) for keep, idx in (
        ref.bindjoin_ref(cand_s[lo:hi], cand_p[lo:hi], cand_o[lo:hi],
                         pat_s, pat_p, pat_o, pat_valid)
        for lo, hi in _row_chunks(cand_s.shape[0], pat_s.shape[0]))]
    return tuple(torch.cat(xs) for xs in zip(*parts, strict=True))


def bindjoin_grouped_plain(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o,
                           pat_valid, *, groups: int):
    """Plain PyTorch version of the grouped kernel, same flat inputs
    (``pat_*`` int32 ``[G * Mp]``) and int32 ``[T, G]`` outputs."""
    mp = pat_s.shape[0] // groups
    pats = [x.reshape(groups, mp) for x in (pat_s, pat_p, pat_o, pat_valid)]
    parts = [_int32_outputs(*ref.bindjoin_grouped_ref(
        cand_s[lo:hi], cand_p[lo:hi], cand_o[lo:hi], *pats))
        for lo, hi in _row_chunks(cand_s.shape[0], groups * mp)]
    return tuple(torch.cat(xs) for xs in zip(*parts, strict=True))


def bindjoin_fused_plain(seg_of_tile, cand_s, cand_p, cand_o, pat_s, pat_p,
                         pat_o, pat_valid, *, segments: int, groups: int,
                         bt: int = DEFAULT_FUSED_BT):
    """Plain PyTorch version of the fused kernel, same flat inputs
    (``pat_*`` int32 ``[S * G * Mp]``, ``seg_of_tile`` int32 ``[T / bt]``)
    and int32 ``[T, G]`` outputs."""
    mp = pat_s.shape[0] // (segments * groups)
    pats = [x.reshape(segments, groups, mp)
            for x in (pat_s, pat_p, pat_o, pat_valid)]
    seg_of_row = seg_of_tile.repeat_interleave(bt)
    parts = [_int32_outputs(*ref.bindjoin_fused_ref(
        cand_s[lo:hi], cand_p[lo:hi], cand_o[lo:hi], seg_of_row[lo:hi],
        *pats))
        for lo, hi in _row_chunks(cand_s.shape[0], groups * mp)]
    return tuple(torch.cat(xs) for xs in zip(*parts, strict=True))


def _check_inputs(cands, pats, n_pat: int) -> torch.device:
    device = cands[0].device
    t = cands[0].shape[0]
    for x in (*cands, *pats):
        if x.dtype != torch.int32 or not x.is_contiguous() \
                or x.dim() != 1 or x.device != device:
            raise ValueError("bind-join inputs must be contiguous 1-D "
                             f"int32 tensors on {device}")
    if any(x.shape[0] != t for x in cands) \
            or any(x.shape[0] != n_pat for x in pats):
        raise ValueError("bind-join input lengths disagree")
    return device


def _outputs(t: int, groups: int, device):
    return tuple(torch.empty((t, groups), dtype=torch.int32, device=device)
                 for _ in range(3))


def bindjoin_cuda(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o, pat_valid):
    """Ungrouped bind-join filter: one candidate pass, one slot set.

    Candidates are int32 ``[T]`` components; pattern inputs are int32
    ``[M]`` slots (M padded by the caller). Returns (keep, idx) int32
    ``[T]`` with ``idx == M`` where a row matches no slot.
    """
    if cand_s.device.type == "cpu":
        return bindjoin_plain(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o,
                              pat_valid)
    if cand_s.device.type != "cuda":
        raise ValueError(f"bindjoin: unsupported device {cand_s.device}")
    m = pat_s.shape[0]
    device = _check_inputs((cand_s, cand_p, cand_o),
                           (pat_s, pat_p, pat_o, pat_valid), m)
    t = cand_s.shape[0]
    keep, idx = (torch.empty((t,), dtype=torch.int32, device=device)
                 for _ in range(2))
    lib = build.library("bindjoin")
    err = lib.brtpf_bindjoin(
        cand_s.data_ptr(), cand_p.data_ptr(), cand_o.data_ptr(),
        pat_s.data_ptr(), pat_p.data_ptr(), pat_o.data_ptr(),
        pat_valid.data_ptr(), keep.data_ptr(), idx.data_ptr(), t, m,
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "bindjoin")
    bindjoin_cuda.launches += 1
    bindjoin_cuda.shapes[(t, m)] += 1
    return keep, idx


bindjoin_cuda.launches = 0
bindjoin_cuda.shapes = Counter()


def bindjoin_grouped_cuda(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o,
                          pat_valid, *, groups: int):
    """Grouped bind-join filter: one candidate pass, G pattern sets.

    Candidates are int32 ``[T]`` components; pattern inputs are flat
    int32 ``[G * Mp]`` slot tables. Returns (keep, idx, nmatch) int32
    ``[T, G]`` with ``idx == Mp`` where a row matches none of group g's
    slots.
    """
    if cand_s.device.type == "cpu":
        return bindjoin_grouped_plain(cand_s, cand_p, cand_o, pat_s, pat_p,
                                      pat_o, pat_valid, groups=groups)
    if cand_s.device.type != "cuda":
        raise ValueError(f"bindjoin_grouped: unsupported device "
                         f"{cand_s.device}")
    gm = pat_s.shape[0]
    if groups < 1 or gm % groups:
        raise ValueError(f"slot table of {gm} is not {groups} groups")
    device = _check_inputs((cand_s, cand_p, cand_o),
                           (pat_s, pat_p, pat_o, pat_valid), gm)
    t = cand_s.shape[0]
    keep, idx, nmatch = _outputs(t, groups, device)
    lib = build.library("bindjoin")
    err = lib.brtpf_bindjoin_grouped(
        cand_s.data_ptr(), cand_p.data_ptr(), cand_o.data_ptr(),
        pat_s.data_ptr(), pat_p.data_ptr(), pat_o.data_ptr(),
        pat_valid.data_ptr(), keep.data_ptr(), idx.data_ptr(),
        nmatch.data_ptr(), t, groups, gm // groups,
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "bindjoin_grouped")
    bindjoin_grouped_cuda.launches += 1
    bindjoin_grouped_cuda.shapes[(t, groups, gm // groups)] += 1
    return keep, idx, nmatch


bindjoin_grouped_cuda.launches = 0
bindjoin_grouped_cuda.shapes = Counter()


def bindjoin_fused_cuda(seg_of_tile, cand_s, cand_p, cand_o, pat_s, pat_p,
                        pat_o, pat_valid, *, segments: int, groups: int,
                        bt: int = DEFAULT_FUSED_BT):
    """Cross-pattern fused bind-join: S segments, one launch.

    ``seg_of_tile`` is int32 ``[T / bt]`` (-1 = dead tile); pattern
    inputs are flat int32 ``[S * G * Mp]`` slot tables; candidates int32
    ``[T]`` with T a multiple of ``bt``. Returns (keep, idx, nmatch)
    int32 ``[T, G]``: column g of a row is its result against its own
    segment's group-g slots (``idx == Mp`` when none match).
    """
    if cand_s.device.type == "cpu":
        return bindjoin_fused_plain(seg_of_tile, cand_s, cand_p, cand_o,
                                    pat_s, pat_p, pat_o, pat_valid,
                                    segments=segments, groups=groups, bt=bt)
    if cand_s.device.type != "cuda":
        raise ValueError(f"bindjoin_fused: unsupported device "
                         f"{cand_s.device}")
    if bt != DEFAULT_FUSED_BT:
        raise ValueError(f"the fused kernel's tile is {DEFAULT_FUSED_BT} "
                         f"rows, not {bt}")
    sgm = pat_s.shape[0]
    if segments < 1 or groups < 1 or sgm % (segments * groups):
        raise ValueError(f"slot table of {sgm} is not {segments} x "
                         f"{groups} groups")
    device = _check_inputs((cand_s, cand_p, cand_o),
                           (pat_s, pat_p, pat_o, pat_valid), sgm)
    t = cand_s.shape[0]
    if t % bt or seg_of_tile.shape != (t // bt,) \
            or seg_of_tile.dtype != torch.int32 \
            or not seg_of_tile.is_contiguous() \
            or seg_of_tile.device != device:
        raise ValueError(f"fused stream of {t} rows needs a contiguous "
                         f"int32 seg_of_tile of {t // bt} tiles on {device}")
    keep, idx, nmatch = _outputs(t, groups, device)
    lib = build.library("bindjoin")
    err = lib.brtpf_bindjoin_fused(
        seg_of_tile.data_ptr(), cand_s.data_ptr(), cand_p.data_ptr(),
        cand_o.data_ptr(), pat_s.data_ptr(), pat_p.data_ptr(),
        pat_o.data_ptr(), pat_valid.data_ptr(), keep.data_ptr(),
        idx.data_ptr(), nmatch.data_ptr(), t, groups,
        sgm // (segments * groups),
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "bindjoin_fused")
    bindjoin_fused_cuda.launches += 1
    bindjoin_fused_cuda.shapes[
        (t, segments, groups, sgm // (segments * groups))] += 1
    return keep, idx, nmatch


bindjoin_fused_cuda.launches = 0
bindjoin_fused_cuda.shapes = Counter()
