"""Padding and dispatch around the kernels (the port of
``repro/kernels/ops.py``).

The ungrouped op pads exactly as the JAX package's op does and hands
structure-of-arrays inputs to its kernel. The grouped and fused ops and
``tpf_match`` hand over the ``[T, 3]`` rows as they lie: their kernels
mask their own edges, so no op pads candidates (the outputs for the
caller's rows are the reference's). The selectors call the windowed
kernels (``bindjoin_grouped_cuda``, ``bindjoin_fused_cuda``) directly,
with the host-side slot tables of ``pack_slots``. Dispatch follows the
tensor's device: a CUDA tensor gets the hand-written kernel, a CPU
tensor its plain PyTorch version. ``compact_mask`` was plain ``jnp`` in
the reference and stays plain torch here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bindjoin import (DEFAULT_BM, DEFAULT_BT, DEFAULT_FUSED_BT,
                       bindjoin_cuda, bindjoin_fused_cuda,
                       bindjoin_grouped_cuda)
from .tpf_match import tpf_match_cuda


def resolve_device(device: Optional[str]) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA, and a
    CUDA device that is not present raises (never a silent CPU run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the kernels' plain "
            "PyTorch versions")
    return dev


def _pad_to(x: torch.Tensor, mult: int, fill: int) -> torch.Tensor:
    n = x.shape[0]
    rem = (-n) % mult
    if rem == 0 and n > 0:
        return x.contiguous()
    pad = max(rem, mult if n == 0 else rem)
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                    device=x.device)])


def bindjoin(cand: torch.Tensor, patterns: torch.Tensor,
             pat_valid: torch.Tensor, *, bt: int = DEFAULT_BT,
             bm: int = DEFAULT_BM) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bind-join filter over candidate triples.

    Args:
      cand: int32 [T, 3] candidate data triples.
      patterns: int32 [M, 3] instantiated patterns (component < 0 = wild).
      pat_valid: int32 [M] (0 marks padding rows).

    Returns:
      keep: bool [T]  -- triple joins with >= 1 attached mapping.
      idx:  int32 [T] -- first matching pattern index (= padded M if none).
    """
    t = cand.shape[0]
    cs, cp, co = (_pad_to(cand[:, i], bt, 0) for i in range(3))
    ps, pp, po = (_pad_to(patterns[:, i], bm, 0) for i in range(3))
    pv = _pad_to(pat_valid.to(torch.int32), bm, 0)
    keep, idx = bindjoin_cuda(cs, cp, co, ps, pp, po, pv)
    return keep[:t].bool(), idx[:t]


def padded_pattern_slots(m: int, bm: int = DEFAULT_BM) -> int:
    """Per-group pattern-slot count after padding to the m-tile size --
    the single source of truth for the launch geometry that
    ``bindjoin_grouped`` uses and the selector charges."""
    return max(m + (-m) % bm, bm)


def pack_slots(patterns: np.ndarray, pat_valid: np.ndarray,
               mp: int) -> Tuple[np.ndarray, int]:
    """Host slot table of the grouped kernel: int32 ``[G, mp, 4]`` rows
    (s, p, o, valid) with zero padding past each group's m slots, and
    ``live``, one past the last valid slot of any group (0 if none): the
    slots the kernel stages per group."""
    g, m = pat_valid.shape
    slots = np.zeros((g, mp, 4), dtype=np.int32)
    slots[:, :m, :3] = patterns
    slots[:, :m, 3] = pat_valid
    valid_cols = np.flatnonzero(np.asarray(pat_valid).any(axis=0))
    live = int(valid_cols[-1]) + 1 if valid_cols.size else 0
    return slots, live


def bindjoin_grouped(cand: torch.Tensor, patterns: torch.Tensor,
                     pat_valid: torch.Tensor, *, bm: int = DEFAULT_BM
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grouped bind-join filter: G pattern sets, one candidate pass.

    Args:
      cand: int32 [T, 3] candidate data triples (shared by all groups).
      patterns: int32 [G, M, 3] per-group instantiated patterns
        (component < 0 = wild).
      pat_valid: int32 [G, M] (0 marks padding rows).

    Returns:
      keep:   bool  [T, G] -- triple joins with >= 1 of group g's patterns.
      idx:    int32 [T, G] -- first matching within-group pattern index
        (= padded M if none).
      nmatch: int32 [T, G] -- matching-pattern count (cnt contribution).

    The windowed kernel with its prologue off: one page over [0, T), a
    wildcard base vector, every row valid, dense outputs.
    """
    t = cand.shape[0]
    mp = padded_pattern_slots(patterns.shape[1], bm)
    slots, live = pack_slots(patterns.cpu().numpy(),
                             pat_valid.cpu().numpy().astype(np.int32), mp)
    dev = cand.device
    wild = torch.as_tensor(pattern_vec_from((-1, -1, -1))).to(dev)
    spans = torch.tensor([[[0, t]]], dtype=torch.int64, device=dev)
    mask, idx, _cnt, nmatch = bindjoin_grouped_cuda(
        cand.to(torch.int32).contiguous()[None], None,
        torch.as_tensor(slots).to(dev), wild, spans=spans,
        width=max(t, 1), live=live, dense=True)
    return (mask[0, 0, :, :t].T.bool(), idx[0, 0, :, :t].T,
            nmatch[0, 0, :, :t].T)


def fused_tile_pages(cand: torch.Tensor, seg_of_tile: torch.Tensor,
                     patterns: torch.Tensor, pat_valid: torch.Tensor, *,
                     bt: int = DEFAULT_FUSED_BT, bm: int = DEFAULT_BM):
    """The fused kernel's inputs for the reference op's flat stream: a
    one-shard store of the ``[T, 3]`` rows, one page per ``bt``-row tile
    (span ``[bt * i, bt * i + bt)``, segment ``seg_of_tile[i]``), the
    segments' slot tables from ``pack_slots`` and wildcard base vectors.
    Returns the positional arguments and the keywords of
    ``bindjoin_fused_cuda`` (dense outputs)."""
    t = cand.shape[0]
    s, g, m = patterns.shape[0], patterns.shape[1], patterns.shape[2]
    if t % bt:
        raise ValueError(f"fused stream of {t} rows is not whole "
                         f"{bt}-row tiles")
    mp = padded_pattern_slots(m, bm)
    slots, live = pack_slots(
        patterns.cpu().numpy().reshape(s * g, m, 3),
        pat_valid.cpu().numpy().astype(np.int32).reshape(s * g, m), mp)
    dev = cand.device
    wild = np.tile(pattern_vec_from((-1, -1, -1)), (s, 1))
    lo = torch.arange(0, t, bt, dtype=torch.int64, device=dev)
    spans = torch.stack([lo, lo + bt], dim=-1)[:, None]
    args = (cand.to(torch.int32).contiguous()[None], None,
            torch.as_tensor(slots.reshape(s, g, mp, 4)).to(dev),
            torch.as_tensor(wild).to(dev))
    return args, dict(spans=spans,
                      seg_of_page=seg_of_tile.to(torch.int32).contiguous(),
                      width=bt, live=live, dense=True)


def bindjoin_fused(cand: torch.Tensor, seg_of_tile: torch.Tensor,
                   patterns: torch.Tensor, pat_valid: torch.Tensor, *,
                   bt: int = DEFAULT_FUSED_BT, bm: int = DEFAULT_BM
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cross-pattern fused bind-join: S segments share one candidate pass.

    Args:
      cand: int32 [T, 3] concatenated candidate stream, T % bt == 0;
        each bt-tile's rows belong to one segment.
      seg_of_tile: int32 [T // bt] per-tile segment id (-1 = dead tile).
      patterns: int32 [S, G, M, 3] per-segment per-group instantiated
        patterns (component < 0 = wild).
      pat_valid: int32 [S, G, M] (0 marks padding rows).

    Returns:
      keep:   bool  [T, G] -- row matches its own segment's group g.
      idx:    int32 [T, G] -- first matching within-group pattern index
        (= padded M if none).
      nmatch: int32 [T, G] -- matching-pattern count (cnt contribution).

    The windowed fused kernel with its prologue off: one page per tile
    (``fused_tile_pages``), dense outputs.
    """
    t, g = cand.shape[0], patterns.shape[1]
    args, kw = fused_tile_pages(cand, seg_of_tile, patterns, pat_valid,
                                bt=bt, bm=bm)
    mask, idx, _cnt, nmatch = bindjoin_fused_cuda(*args, **kw)

    def rows(x):                             # (P, 1, G, bt) -> (T, G)
        return x[:, 0].transpose(1, 2).reshape(t, g)

    return rows(mask).bool(), rows(idx), rows(nmatch)


def tpf_match(cand: torch.Tensor, pattern_vec: torch.Tensor) -> torch.Tensor:
    """Single-pattern match mask over candidate triples.

    Args:
      cand: int32 [T, 3]; pattern_vec: int32 [8]
        = [s, p, o, eq_sp, eq_so, eq_po, 0, 0], components < 0 wild.
    Returns: bool [T] (the kernel's uint8 mask, viewed as bool).
    """
    mask = tpf_match_cuda(cand.to(torch.int32).contiguous(),
                          pattern_vec.to(torch.int32).contiguous())
    return mask.view(torch.bool)


def compact_mask(mask: torch.Tensor, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Turn a bool mask ``[..., N]`` into (indices ``[..., capacity]``,
    count ``[...]``): kept positions first, ascending, then -1 padding.

    Works along the last axis, so a ``[G, N]`` mask compacts every
    group's column in one call (the reference ``vmap``s over G). The
    stable sort is on an integer key: 0 for kept rows, 1 for dropped.
    """
    count = mask.sum(dim=-1, dtype=torch.int32)
    key = (~mask).to(torch.uint8)
    order = torch.sort(key, dim=-1, stable=True).indices.to(torch.int32)
    n = order.shape[-1]
    if n < capacity:
        order = torch.cat([order, torch.full(
            (*order.shape[:-1], capacity - n), -1, dtype=torch.int32,
            device=order.device)], dim=-1)
    idx = order[..., :capacity]
    valid = torch.arange(capacity, device=mask.device) < count[..., None]
    return torch.where(valid, idx, torch.full_like(idx, -1)), count


def pattern_vec_from(tp_tuple, eq_sp=0, eq_so=0, eq_po=0) -> np.ndarray:
    """Host helper: build the int32[8] pattern vector for tpf_match."""
    s, p, o = tp_tuple
    return np.array([s, p, o, eq_sp, eq_so, eq_po, 0, 0], dtype=np.int32)
