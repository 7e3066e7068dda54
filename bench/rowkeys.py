"""Rows of integer columns sorted, made distinct and keyed exactly, at
any width of the ids (term ids up to 2**31 - 1).

Where the columns fit one int64 together, a row is packed into one key,
first column highest: each column offset by its least value and given
the bits its range needs. Where they need more than ``KEY_BITS`` bits,
rows are sorted by ``np.lexsort`` and keyed by their rank among the
distinct rows. Both ways give the same rows in the same order and keys
that order and equate rows as the rows themselves compare, first column
first. The datagen's triples past 21-bit ids, and the reference's
permutations, first occurrences and join keys, are all made here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# Bits a packed key may take (int64 without its sign bit).
KEY_BITS = 63


def _packing(cols: Sequence[np.ndarray]
             ) -> Optional[List[Tuple[int, int, int]]]:
    """(least value, shift, bits) of each column in one packed key, or
    None where the columns' ranges need more than ``KEY_BITS`` bits."""
    fields = []
    for c in cols:
        lo, hi = (int(c.min()), int(c.max())) if c.size else (0, 0)
        fields.append((lo, (hi - lo).bit_length()))
    shift = sum(bits for _, bits in fields)
    if shift > KEY_BITS:
        return None
    out = []
    for lo, bits in fields:
        shift -= bits
        out.append((lo, shift, bits))
    return out


def _pack(cols, packing) -> np.ndarray:
    key = np.zeros(cols[0].shape[0] if cols else 0, dtype=np.int64)
    for c, (lo, shift, _) in zip(cols, packing):
        part = c.astype(np.int64)
        part -= lo
        part <<= shift
        key |= part
    return key


def _first_of_each(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Rows of sorted columns that differ from the row before them."""
    n = cols[0].shape[0]
    new = np.zeros(n, dtype=bool)
    if n:
        new[0] = True
        for c in cols:
            new[1:] |= c[1:] != c[:-1]
    return new


def sorted_rows(cols: Sequence[np.ndarray],
                distinct: bool = False) -> List[np.ndarray]:
    """The rows of ``cols`` (int32 values) sorted, first
    column first, and with ``distinct`` each kept once: the columns of
    the result, each a contiguous int32 array."""
    cols = [np.asarray(c) for c in cols]
    packing = _packing(cols)
    if packing is None:
        order = np.lexsort(cols[::-1])
        cols = [c[order] for c in cols]
        if distinct:
            keep = _first_of_each(cols)
            cols = [c[keep] for c in cols]
        return [np.ascontiguousarray(c, dtype=np.int32) for c in cols]
    keys = np.sort(_pack(cols, packing))
    if distinct:
        keys = keys[_first_of_each([keys])]
    out = []
    for lo, shift, bits in packing:
        c = keys >> shift
        c &= (1 << bits) - 1
        c += lo
        out.append(c.astype(np.int32))
    return out


def keys(cols: Sequence[np.ndarray]) -> np.ndarray:
    """One int64 key a row of ``cols``: equal for equal rows, and ordered
    as the rows are, first column first."""
    cols = [np.asarray(c) for c in cols]
    packing = _packing(cols)
    if packing is not None:
        return _pack(cols, packing)
    order = np.lexsort(cols[::-1])
    rank = np.empty(order.shape[0], dtype=np.int64)
    rank[order] = np.cumsum(_first_of_each([c[order] for c in cols])) - 1
    return rank
