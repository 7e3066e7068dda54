"""The plain reference: brTPF fragments and BGP solutions in NumPy.

It follows the paper's server algorithm (arXiv:1608.08148 section 4.1,
Definitions 1 and 2) over an HDT-like store of three sorted
permutations, and states every choice the served fragments are held to:

* a triple pattern's matches stream from the permutation (SPO, POS or
  OSP, tried in that order, the first with the longest bound prefix)
  whose key order puts the pattern's bound components first, in that
  permutation's key order;
* a brTPF request instantiates its pattern with each attached mapping in
  turn, drops repeated instantiations, and concatenates their match
  streams, keeping each triple's first occurrence;
* ``cnt`` is the sum of the instantiations' stream sizes;
* page ``k`` is triples ``[k * page_size, (k + 1) * page_size)`` of the
  sequence, and ``has_next`` says whether triples follow it.

It imports nothing of the system under test: it is handed the seeded
triples and the requests as plain arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import rowkeys

ORDERS = (("spo", (0, 1, 2)), ("pos", (1, 2, 0)), ("osp", (2, 0, 1)))
UNBOUND = -1


class ReferenceStore:
    """Three sorted permutations of a set of triples (term ids up to
    2**31 - 1), each held as its three columns in key order."""

    def __init__(self, triples: np.ndarray) -> None:
        t = np.asarray(triples).reshape(-1, 3)
        cols = rowkeys.sorted_rows(list(t.T), distinct=True)
        self.triples = np.stack(cols, axis=1)
        # the distinct rows are in SPO order already
        self.cols: Dict[str, List[np.ndarray]] = {
            name: cols if name == "spo" else
            rowkeys.sorted_rows([cols[i] for i in order])
            for name, order in ORDERS}

    @staticmethod
    def _index(pattern) -> Tuple[str, Tuple[int, int, int], int]:
        best = ("spo", ORDERS[0][1], 0)
        for name, order in ORDERS:
            plen = 0
            for comp in order:
                if pattern[comp] < 0:
                    break
                plen += 1
            if plen > best[2]:
                best = (name, order, plen)
        return best

    def _range(self, pattern):
        """The columns of the pattern's bound-prefix range, narrowed one
        bound component at a time, and the permutation's order."""
        name, order, plen = self._index(pattern)
        cols = self.cols[name]
        lo, hi = 0, cols[0].shape[0]
        for i in range(plen):
            # an int32 value: a Python int would cast the column to int64
            col, v = cols[i][lo:hi], np.int32(pattern[order[i]])
            lo, hi = (lo + int(np.searchsorted(col, v, side="left")),
                      lo + int(np.searchsorted(col, v, side="right")))
        return [c[lo:hi] for c in cols], order

    def range_size(self, pattern) -> int:
        """Rows of the pattern's bound-prefix range (at least its
        matches)."""
        return int(self._range([int(x) for x in pattern])[0][0].shape[0])

    def match(self, pattern) -> np.ndarray:
        """int32 ``[M, 3]`` triples matching ``pattern`` (constants >= 0,
        variables < 0, a repeated variable binds equal components), in
        the chosen permutation's order."""
        pattern = [int(x) for x in pattern]
        cols, order = self._range(pattern)
        rows = np.empty((cols[0].shape[0], 3), dtype=np.int32)
        for i, comp in enumerate(order):
            rows[:, comp] = cols[i]
        keep = np.ones(rows.shape[0], dtype=bool)
        for comp in range(3):
            if pattern[comp] >= 0:
                keep &= rows[:, comp] == pattern[comp]
            for other in range(comp + 1, 3):
                if pattern[comp] < 0 and pattern[comp] == pattern[other]:
                    keep &= rows[:, comp] == rows[:, other]
        return rows[keep]


def instantiate(pattern, mapping) -> Tuple[int, int, int]:
    """Each variable component ``-(v + 1)`` bound by ``mapping[v]``."""
    out = []
    for c in pattern:
        c = int(c)
        if c < 0:
            v = -c - 1
            b = int(mapping[v]) if v < len(mapping) else UNBOUND
            out.append(c if b == UNBOUND else b)
        else:
            out.append(c)
    return tuple(out)


def fragment(store: ReferenceStore, pattern,
             omega: Optional[np.ndarray]) -> Tuple[np.ndarray, int]:
    """A fragment's whole data sequence and its ``cnt``."""
    if omega is None or len(omega) == 0:
        insts = [tuple(int(x) for x in pattern)]
    else:
        insts = list(dict.fromkeys(instantiate(pattern, row)
                                   for row in np.asarray(omega)))
    streams = [store.match(p) for p in insts]
    cnt = int(sum(s.shape[0] for s in streams))
    return first_occurrences(streams), cnt


def first_occurrences(streams: List[np.ndarray]) -> np.ndarray:
    """The streams concatenated, each triple kept where it first
    occurs."""
    cat = np.concatenate(streams) if streams else np.empty((0, 3), np.int32)
    if len(streams) > 1 and cat.shape[0]:
        _, first = np.unique(rowkeys.keys(list(cat.T)), return_index=True)
        cat = cat[np.sort(first)]
    return cat.astype(np.int32)


def page(data: np.ndarray, cnt: int, page_no: int,
         page_size: int) -> Tuple[np.ndarray, int, bool]:
    lo = page_no * page_size
    return data[lo:lo + page_size], cnt, lo + page_size < data.shape[0]


def solutions(store: ReferenceStore, patterns: np.ndarray) -> np.ndarray:
    """Every solution of a BGP (int ``[n, 3]``), int32 ``[R, V]`` rows
    sorted and distinct. The patterns are joined in turn, each time the
    one with the smallest range among those sharing a variable with the
    patterns already joined; a join is a sort-merge, on their shared
    variables, of the solutions so far with the pattern's matches (those
    of its instantiations by each distinct binding, where there are few
    bindings)."""
    patterns = np.asarray(patterns, dtype=np.int64)
    nv = int(-patterns[patterns < 0].min()) if (patterns < 0).any() else 0
    sizes = [store.range_size(p) for p in patterns]
    todo = list(range(len(patterns)))
    bound: set = set()
    sols = np.full((1, nv), UNBOUND, dtype=np.int32)
    while todo and sols.shape[0]:
        linked = [i for i in todo if _vars(patterns[i]) & bound]
        i = min(linked or todo, key=lambda i: (sizes[i], i))
        todo.remove(i)
        sols = _join(patterns[i], _rows(store, patterns[i], sols, bound),
                     sols, bound)
        bound |= _vars(patterns[i])
    if sols.shape[0] == 0:
        return np.empty((0, nv), dtype=np.int32)
    return np.unique(sols, axis=0)


def _vars(pattern) -> set:
    return {-int(c) - 1 for c in pattern if c < 0}


FEW_BINDINGS = 512


def _rows(store: ReferenceStore, pattern, sols: np.ndarray,
          bound: set) -> np.ndarray:
    """The pattern's matches that can join with ``sols``."""
    shared = sorted(_vars(pattern) & bound)
    if not shared:
        return store.match(pattern)
    keys = np.unique(sols[:, shared], axis=0)
    if keys.shape[0] > FEW_BINDINGS:
        return store.match(pattern)
    mapping = np.full(sols.shape[1], UNBOUND, dtype=np.int64)
    parts = []
    for key in keys:
        mapping[shared] = key
        parts.append(store.match(instantiate(pattern, mapping)))
    return np.concatenate(parts)


def _join(pattern, rows: np.ndarray, sols: np.ndarray,
          bound: set) -> np.ndarray:
    """Solutions extended by every matching row (``rows``, the
    pattern's matches) that agrees with them on the bound variables."""
    var_pos: Dict[int, int] = {}
    for comp, c in enumerate(pattern):
        if c < 0:
            var_pos.setdefault(-int(c) - 1, comp)
    shared = sorted(set(var_pos) & bound)
    if shared:
        key = rowkeys.keys([np.concatenate([rows[:, var_pos[v]], sols[:, v]])
                            for v in shared])
        row_key, sol_key = key[:rows.shape[0]], key[rows.shape[0]:]
    else:
        row_key = np.zeros(rows.shape[0], np.int64)
        sol_key = np.zeros(sols.shape[0], np.int64)
    order = np.argsort(row_key, kind="stable")
    row_key = row_key[order]
    lo = np.searchsorted(row_key, sol_key, side="left")
    cnt = np.searchsorted(row_key, sol_key, side="right") - lo
    total = int(cnt.sum())
    start = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    picked = rows[order[start + np.arange(total)]]
    out = np.repeat(sols, cnt, axis=0)
    for v, comp in var_pos.items():
        out[:, v] = picked[:, comp]
    return out
