"""Ungrouped, grouped and fused bind-join filters (the brTPF server's hot
spot).

The hand-written CUDA kernels are in ``csrc/bindjoin.cu``. They replace
the TPU kernels ``repro/kernels/bindjoin.py:bindjoin_pallas``,
``:bindjoin_grouped_pallas`` and ``:bindjoin_fused_pallas``; the grouped
and fused kernels also take over the ``tpf_match`` base mask of every
grouped or fused step.

The grouped kernel serves a chunk of P window pages of S shards in one
launch, reading the store's own ``[S, N, 3]`` rows: per (page, shard) an
owned span ``[lo, hi)`` or an explicit row list, a fused prologue (span,
valid flag, base pattern with its repeated-variable flags), then a loop
over each group's live slots only. It writes ``mask`` uint8
``[P, S, G, W]``, the first matching slot ``first`` int32 (Mp when none)
and the Definition-2 ``cnt`` int64 ``[P, S, G]``. With a wildcard base
vector, one page over ``[0, T)`` and ``dense=True`` (``first`` and
``nmatch`` for every row) it is the reference op's grouped bind-join.

The fused kernel is the same kernel over pages of several segments (the
requests of a heterogeneous batch, each with its own pattern): each page
has a segment id (``seg_of_page``, -1 = dead) and is matched against
that segment's slot table and base vector, with the same outputs. One
256-row page per candidate tile and wildcard base vectors make it the
reference op's fused bind-join. The ungrouped kernel (the sharded
backend's full-shard stream) computes ``keep`` and ``idx`` int32 ``[T]``
against one slot set, with ``idx`` = the padded M where no slot matches.

Each ``*_cuda`` wrapper dispatches on the tensor's device: a CUDA tensor
launches the kernel (counted in the wrapper's ``launches``, its geometry
tallied in ``shapes``), a CPU tensor takes the ``*_plain`` version.
There is no fallback: a CUDA launch that fails raises.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import build, ref

DEFAULT_BT = 1024
DEFAULT_BM = 128

# The JAX package's fused launches tile the candidate stream finer than
# its same-pattern grouped kernel: each segment's block is tile-aligned
# independently, so a smaller tile bounds the per-segment alignment
# waste. The fused op keeps the tile as its contract (one segment id per
# tile) and hands the kernel one page per tile.
DEFAULT_FUSED_BT = 256

# The plain versions build a [rows, G, Mp] compare grid; they walk the
# rows in chunks so that the grid stays near this many cells.
PLAIN_CHUNK_CELLS = 1 << 26


def _row_chunks(t: int, cells_per_row: int):
    """Row ranges of the plain versions' chunks (one, empty, if t == 0)."""
    step = max(1, PLAIN_CHUNK_CELLS // max(cells_per_row, 1))
    for lo in range(0, max(t, 1), step):
        yield lo, min(lo + step, t)


def bindjoin_plain(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o, pat_valid):
    """Plain PyTorch version of the ungrouped kernel, same flat inputs
    (``pat_*`` int32 ``[M]``) and int32 ``[T]`` outputs (keep, idx)."""
    parts = [(keep.to(torch.int32), idx) for keep, idx in (
        ref.bindjoin_ref(cand_s[lo:hi], cand_p[lo:hi], cand_o[lo:hi],
                         pat_s, pat_p, pat_o, pat_valid)
        for lo, hi in _row_chunks(cand_s.shape[0], pat_s.shape[0]))]
    return tuple(torch.cat(xs) for xs in zip(*parts, strict=True))


def _window_positions(spans, rows, width: int, n: int):
    """Positions int64 ``[P, S, W]`` a launch reads, and which of them
    lie in their span (or list) and below ``n``."""
    if rows is None:
        pos = spans[..., :1] + torch.arange(width, device=spans.device)
        inside = (pos >= 0) & (pos < spans[..., 1:])
    else:
        pos = rows.to(torch.int64)
        inside = pos >= 0
    return pos, inside & (pos < n)


def bindjoin_grouped_plain(triples, valid, slots, base_vec, *, spans=None,
                           rows=None, width: int, live=None,
                           dense: bool = False):
    """Plain PyTorch version of the grouped kernel: the same inputs and
    outputs (``live`` is the kernel's staging width and changes
    nothing here: slots past a group's last valid one match nothing).
    ``first`` is Mp wherever the mask is clear; the kernel leaves those
    entries unset unless ``dense``."""
    del live
    s, n = triples.shape[:2]
    g, mp = slots.shape[:2]
    pos, ok = _window_positions(spans, rows, width, n)
    p = pos.shape[0]
    shard = torch.arange(s, device=triples.device)[None, :, None]
    safe = torch.where(ok, pos, 0)
    cand = triples[shard, safe].reshape(-1, 3)            # (P * S * W, 3)
    if valid is not None:
        ok = ok & valid[shard, safe].bool()
    ok = ok.reshape(-1) & ref.tpf_match_ref(cand[:, 0], cand[:, 1],
                                            cand[:, 2], base_vec)
    pats = [slots[..., i] for i in range(4)]
    parts = [ref.bindjoin_grouped_ref(cand[lo:hi, 0], cand[lo:hi, 1],
                                      cand[lo:hi, 2], *pats)
             for lo, hi in _row_chunks(cand.shape[0], g * mp)]
    keep, idx, nmatch = (torch.cat(xs) for xs in zip(*parts, strict=True))
    ok = ok[:, None]
    nmatch = torch.where(ok, nmatch, 0)
    idx = torch.where(ok, idx, mp)

    def cells(x):                                   # (R, G) -> (P, S, G, W)
        return x.reshape(p, s, width, g).permute(0, 1, 3, 2).contiguous()

    mask = cells((keep & ok).to(torch.uint8))
    cnt = nmatch.to(torch.int64).reshape(p, s, width, g).sum(dim=2)
    return mask, cells(idx), cnt, cells(nmatch) if dense else None


def bindjoin_fused_plain(triples, valid, slots, base_vecs, *, spans,
                         seg_of_page, width: int, live=None,
                         dense: bool = False):
    """Plain PyTorch version of the fused kernel: the same inputs and
    outputs. Each segment's pages go through the grouped kernel's plain
    version with that segment's slot table and base vector; a page whose
    id lies outside ``[0, Sseg)`` keeps nothing (``first`` Mp, ``nmatch``
    0)."""
    del live
    s = triples.shape[0]
    g, mp = slots.shape[1:3]
    p = spans.shape[0]
    dev = triples.device
    mask = torch.zeros((p, s, g, width), dtype=torch.uint8, device=dev)
    first = torch.full((p, s, g, width), mp, dtype=torch.int32, device=dev)
    cnt = torch.zeros((p, s, g), dtype=torch.int64, device=dev)
    nmatch = torch.zeros((p, s, g, width), dtype=torch.int32,
                         device=dev) if dense else None
    for sid in range(slots.shape[0]):
        pages = torch.nonzero(seg_of_page == sid)[:, 0]
        if pages.numel() == 0:
            continue
        out = bindjoin_grouped_plain(triples, valid, slots[sid],
                                     base_vecs[sid], spans=spans[pages],
                                     width=width, dense=dense)
        for whole, part in zip((mask, first, cnt, nmatch), out,
                               strict=True):
            if whole is not None:
                whole[pages] = part
    return mask, first, cnt, nmatch


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


def _check_grouped(triples, valid, slots, base_vec, spans, rows,
                   width: int, live: int):
    device = triples.device
    if triples.dtype != torch.int32 or triples.dim() != 3 \
            or triples.shape[2] != 3 or not triples.is_contiguous():
        raise ValueError("triples must be a contiguous int32 [S, N, 3]")
    s, n = triples.shape[:2]
    if valid is not None and (valid.dtype not in (torch.bool, torch.uint8)
                              or tuple(valid.shape) != (s, n)
                              or not valid.is_contiguous()
                              or valid.device != device):
        raise ValueError(f"valid must be a contiguous bool [{s}, {n}]")
    if slots.dtype != torch.int32 or slots.dim() != 3 \
            or slots.shape[2] != 4 or not slots.is_contiguous() \
            or slots.device != device or slots.data_ptr() % 16:
        raise ValueError("slots must be a contiguous int32 [G, Mp, 4] "
                         "on a 16-byte boundary (the kernel reads int4)")
    if base_vec.dtype != torch.int32 or tuple(base_vec.shape) != (8,) \
            or not base_vec.is_contiguous() or base_vec.device != device:
        raise ValueError("base_vec must be a contiguous int32 [8]")
    if (spans is None) == (rows is None):
        raise ValueError("give exactly one of spans and rows")
    if spans is not None:
        ok = (spans.dtype == torch.int64 and spans.dim() == 3
              and spans.shape[1:] == (s, 2))
        where = spans
    else:
        ok = (rows.dtype == torch.int32 and rows.dim() == 3
              and rows.shape[1:] == (s, width))
        where = rows
    if not ok or not where.is_contiguous() or where.device != device:
        raise ValueError(f"spans must be int64 [P, {s}, 2] or rows int32 "
                         f"[P, {s}, {width}], contiguous, on {device}")
    if width < 1 or not 0 <= live <= slots.shape[1]:
        raise ValueError(f"width {width} or live {live} out of range")
    return where.shape[0]


def _window_outputs(p: int, s: int, g: int, width: int, device,
                    dense: bool):
    """The windowed kernels' outputs: mask, first, cnt (zeroed: the
    kernels add into it) and, with ``dense``, nmatch."""
    first = torch.empty((p, s, g, width), dtype=torch.int32, device=device)
    return (torch.empty((p, s, g, width), dtype=torch.uint8, device=device),
            first, torch.zeros((p, s, g), dtype=torch.int64, device=device),
            torch.empty_like(first) if dense else None)


def bindjoin_grouped_cuda(triples, valid, slots, base_vec, *, spans=None,
                          rows=None, width: int, live: int,
                          dense: bool = False):
    """Grouped bind-join over a chunk of window pages: one launch.

    ``triples`` int32 ``[S, N, 3]`` and ``valid`` bool ``[S, N]`` (or
    None: every row valid) are read where they lie. Each of the P pages
    gives every shard either an owned span (``spans`` int64 ``[P, S, 2]``,
    positions ``lo + r`` for ``r < width``, kept below ``hi``) or a row
    list (``rows`` int32 ``[P, S, width]``, -1 = no row). ``slots`` is
    the int32 ``[G, Mp, 4]`` table (s, p, o, valid; component < 0 =
    wildcard), ``base_vec`` the int32 ``[8]`` base pattern vector, and
    ``live`` the slots staged per group: at least one past every
    group's last valid slot, at most Mp.

    Returns ``mask`` uint8 ``[P, S, G, W]``, ``first`` int32 (the first
    matching slot, Mp when none; set where the mask is, and everywhere
    with ``dense``), ``cnt`` int64 ``[P, S, G]`` (the Definition-2 sum of
    matching slots over kept rows) and, with ``dense``, ``nmatch`` int32
    ``[P, S, G, W]`` (else None).
    """
    if triples.device.type == "cpu":
        return bindjoin_grouped_plain(triples, valid, slots, base_vec,
                                      spans=spans, rows=rows, width=width,
                                      live=live, dense=dense)
    if triples.device.type != "cuda":
        raise ValueError(f"bindjoin_grouped: unsupported device "
                         f"{triples.device}")
    p = _check_grouped(triples, valid, slots, base_vec, spans, rows, width,
                       live)
    s, n = triples.shape[:2]
    g, mp = slots.shape[:2]
    device = triples.device
    mask, first, cnt, nmatch = _window_outputs(p, s, g, width, device,
                                               dense)
    if mask.numel() == 0:
        return mask, first, cnt, nmatch
    lib = build.library("bindjoin")
    err = lib.brtpf_bindjoin_grouped(
        triples.data_ptr(), None if valid is None else valid.data_ptr(),
        None if spans is None else spans.data_ptr(),
        None if rows is None else rows.data_ptr(), slots.data_ptr(),
        base_vec.data_ptr(), mask.data_ptr(), first.data_ptr(),
        cnt.data_ptr(), None if nmatch is None else nmatch.data_ptr(), n, p,
        s, width, g, mp, live, torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "bindjoin_grouped")
    bindjoin_grouped_cuda.launches += 1
    bindjoin_grouped_cuda.shapes[(p, s, width, g, mp, live)] += 1
    return mask, first, cnt, nmatch


bindjoin_grouped_cuda.launches = 0
bindjoin_grouped_cuda.shapes = Counter()


def _check_fused(triples, valid, slots, base_vecs, spans, seg_of_page,
                 width: int, live: int):
    device = triples.device
    if slots.dim() != 4 or tuple(base_vecs.shape) != (slots.shape[0], 8) \
            or slots.shape[0] < 1:
        raise ValueError("slots must be int32 [Sseg, G, Mp, 4] and "
                         "base_vecs int32 [Sseg, 8]")
    if not slots.is_contiguous() or not base_vecs.is_contiguous():
        raise ValueError("slots and base_vecs must be contiguous")
    p = _check_grouped(triples, valid, slots[0], base_vecs[0], spans, None,
                       width, live)
    if seg_of_page.dtype != torch.int32 or tuple(seg_of_page.shape) != (p,) \
            or not seg_of_page.is_contiguous() \
            or seg_of_page.device != device:
        raise ValueError(f"seg_of_page must be a contiguous int32 [{p}] on "
                         f"{device}")
    return p


def bindjoin_fused_cuda(triples, valid, slots, base_vecs, *, spans,
                        seg_of_page, width: int, live: int,
                        dense: bool = False):
    """Fused bind-join over a chunk of window pages of several segments:
    one launch.

    The grouped kernel's contract (``bindjoin_grouped_cuda``, spans
    only), with one slot table and base vector per segment: ``slots``
    int32 ``[Sseg, G, Mp, 4]``, ``base_vecs`` int32 ``[Sseg, 8]``, and
    ``seg_of_page`` int32 ``[P]`` naming each page's segment (an id
    outside ``[0, Sseg)``, such as -1, marks a dead page that keeps
    nothing). ``live`` is at least one past every group's last valid
    slot in every segment. Returns the grouped wrapper's four outputs.
    """
    if triples.device.type == "cpu":
        return bindjoin_fused_plain(triples, valid, slots, base_vecs,
                                    spans=spans, seg_of_page=seg_of_page,
                                    width=width, live=live, dense=dense)
    if triples.device.type != "cuda":
        raise ValueError(f"bindjoin_fused: unsupported device "
                         f"{triples.device}")
    p = _check_fused(triples, valid, slots, base_vecs, spans, seg_of_page,
                     width, live)
    s, n = triples.shape[:2]
    segs, g, mp = slots.shape[:3]
    device = triples.device
    mask, first, cnt, nmatch = _window_outputs(p, s, g, width, device,
                                               dense)
    if mask.numel() == 0:
        return mask, first, cnt, nmatch
    lib = build.library("bindjoin")
    err = lib.brtpf_bindjoin_fused(
        triples.data_ptr(), None if valid is None else valid.data_ptr(),
        spans.data_ptr(), seg_of_page.data_ptr(), slots.data_ptr(),
        base_vecs.data_ptr(), mask.data_ptr(), first.data_ptr(),
        cnt.data_ptr(), None if nmatch is None else nmatch.data_ptr(), n, p,
        s, width, g, mp, segs, live,
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "bindjoin_fused")
    bindjoin_fused_cuda.launches += 1
    bindjoin_fused_cuda.shapes[(p, s, width, g, mp, live, segs)] += 1
    return mask, first, cnt, nmatch


bindjoin_fused_cuda.launches = 0
bindjoin_fused_cuda.shapes = Counter()
