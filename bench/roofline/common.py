"""Operations and bytes of the windowed bind-join kernels
(``csrc/bindjoin.cu`` of the port), counted from one launch's inputs.

Work per (row, slot) cell: 3 component compares, 2 ANDs, 1 add into the
count and 1 min into the first slot (``OPS_PER_CELL``); per row read,
the prologue's 3 component compares and 3 repeated-variable compares
(``OPS_PER_ROW``). A row is read if its position lies in its page's
span (or row list), below the shard's length, and, where the launch has
valid flags, is valid; it passes the prologue's base test, since every
pattern the brTPF templates give is answered from the range of its bound
prefix and repeats no variable. Its cells are those of its page's
segment's groups, each up to one past its last valid slot.

Bytes: each row read once (12 bytes, 13 with a valid flag), the mask
written for it (one byte per group), ``cnt`` (8 bytes per page, shard
and group), the live slots (16 bytes each), the spans (16 bytes per page
and shard) or row lists (4 bytes per entry), the page's segment id, and
the base vectors (32 bytes a segment). The ``first`` slot written for a
kept row is left out: it depends on the output. So the bound is a lower
bound, and the share of it cannot pass 100% by this count.

These are the counts of the port's ``chip_smoke.py`` kernel cases,
applied to a launch's own inputs.
"""
from __future__ import annotations

OPS_PER_CELL = 7
OPS_PER_ROW = 6


def facts(triples, valid, slots, base, *, spans=None, rows=None, width,
          live, seg_of_page=None, **_):
    """What ``work`` needs of one launch, without reading the device:
    host ints and references to the small input tensors."""
    return dict(s=int(triples.shape[0]), n=int(triples.shape[1]),
                valid=valid, slots=slots, spans=spans, rows=rows,
                width=int(width), seg_of_page=seg_of_page,
                segs=1 if slots.dim() == 3 else int(slots.shape[0]))


def work(f):
    """(operations, bytes) of one launch. Reads its small inputs back
    from the device: call it after the measured window."""
    import torch
    slots = f["slots"] if f["slots"].dim() == 4 else f["slots"][None]
    segs, g, mp = slots.shape[:3]
    valid_slot = (slots[..., 3] != 0).to(torch.int64)
    pos = torch.arange(1, mp + 1, device=slots.device)
    live = (valid_slot * pos).amax(dim=-1).sum(dim=-1)      # [segs]
    n, width = f["n"], f["width"]
    if f["rows"] is not None:
        where = f["rows"].to(torch.int64)
        inside = (where >= 0) & (where < n)
    else:
        sp = f["spans"]
        where = sp[..., :1] + torch.arange(width, device=sp.device)
        inside = (where >= 0) & (where < sp[..., 1:]) & (where < n)
    p, s = where.shape[:2]
    if f["valid"] is not None:
        shard = torch.arange(s, device=where.device)[None, :, None]
        safe = torch.where(inside, where, 0)
        inside = inside & f["valid"][shard, safe].bool()
    rows_pp = inside.sum(dim=(1, 2))                          # [P]
    if f["seg_of_page"] is not None:
        seg = f["seg_of_page"].to(torch.int64)
        alive = (seg >= 0) & (seg < segs)
        rows_pp = torch.where(alive, rows_pp, 0)
        cell_live = live[seg.clamp(0, segs - 1)]
    else:
        cell_live = live.expand(p)
    rows = int(rows_pp.sum())
    cells = int((rows_pp * cell_live).sum())
    span_bytes = 16 * p * s if f["rows"] is None else 4 * p * s * width
    nbytes = ((13 if f["valid"] is not None else 12) * rows + rows * g
              + 8 * p * s * g + 16 * int(live.sum()) + span_bytes
              + (4 * p if f["seg_of_page"] is not None else 0) + 32 * segs)
    return OPS_PER_ROW * rows + OPS_PER_CELL * cells, nbytes
