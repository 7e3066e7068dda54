"""Selector functions and fragments (paper Definitions 1 and 2).

``tpf_select`` is the classic triple-pattern selector. ``brtpf_select``
implements the bindings-restricted selector s_(tp, Omega) exactly as the
server algorithm in paper section 4.1 computes it:

  1. iterate over the sequence Omega of solution mappings;
  2. apply each mapping to tp, yielding (potentially) more concrete
     triple patterns;
  3. remove duplicate instantiated patterns;
  4. evaluate each remaining pattern against the backend and concatenate
     the resulting match streams.

The concatenated stream is the fragment's data-triple sequence; paging
slices that sequence deterministically (Omega is a *sequence*, so the
instantiation order -- and hence the page contents -- is well defined,
which is why Definition 2 insists on sequences rather than sets).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .rdf import TriplePattern
from .store import TripleStore


def tpf_select(store: TripleStore, tp: TriplePattern) -> np.ndarray:
    """Definition 1, empty-Omega branch: all matching triples."""
    return store.match(tp)


def instantiate_patterns(
    tp: TriplePattern, omega: Optional[np.ndarray]
) -> List[TriplePattern]:
    """Steps 1-3 of the server algorithm: instantiate + dedup (ordered)."""
    if omega is None or omega.shape[0] == 0:
        return [tp]
    seen = {}
    out: List[TriplePattern] = []
    for row in omega:
        inst = tp.instantiate(row)
        key = inst.as_tuple()
        if key not in seen:
            seen[key] = True
            out.append(inst)
    return out


def brtpf_select_with_cnt(
    store: TripleStore, tp: TriplePattern, omega: Optional[np.ndarray]
) -> Tuple[np.ndarray, int]:
    """Definition 1 selector + Definition 2 ``cnt`` in one backend pass.

    Returns the fragment's data-triple *sequence* (concatenated streams,
    cross-stream duplicates removed so the result is a set of triples as
    Definition 3 of the LDF framework requires Gamma to be) and the
    cardinality estimate (sum of per-instantiation stream sizes, which
    over-counts cross-stream duplicates -- a bounded-error estimate as
    Definition 2(b) permits: abs(|Gamma| - cnt) <= eps).
    """
    streams = [store.match(p) for p in instantiate_patterns(tp, omega)]
    cnt = int(sum(s.shape[0] for s in streams))
    if len(streams) == 1:
        return streams[0], cnt
    cat = np.concatenate([s for s in streams if s.shape[0]], axis=0) \
        if any(s.shape[0] for s in streams) else np.empty((0, 3), np.int32)
    if cat.shape[0] == 0:
        return cat, cnt
    # Ordered dedup: keep first occurrence (deterministic paging).
    _, first = np.unique(cat, axis=0, return_index=True)
    return cat[np.sort(first)], cnt


def brtpf_select(
    store: TripleStore, tp: TriplePattern, omega: Optional[np.ndarray]
) -> np.ndarray:
    return brtpf_select_with_cnt(store, tp, omega)[0]


def brtpf_cardinality(
    store: TripleStore, tp: TriplePattern, omega: Optional[np.ndarray]
) -> int:
    return brtpf_select_with_cnt(store, tp, omega)[1]


def brtpf_count(
    store: TripleStore, tp: TriplePattern, omega: Optional[np.ndarray]
) -> int:
    """Definition-2 ``cnt`` without materializing the data sequence.

    The count-only fast path for count probes: ``store.cardinality`` is
    a pure searchsorted for prefix patterns (the common case), so no
    match stream is gathered or concatenated. Equal to
    ``brtpf_select_with_cnt(...)[1]`` by construction -- cardinality's
    scan fallback is an exact count.
    """
    return int(sum(store.cardinality(p)
                   for p in instantiate_patterns(tp, omega)))


@dataclasses.dataclass
class Fragment:
    """One page of a (br)TPF -- the wire-level unit (LDF Definition 3).

    ``data`` are the page's data triples; ``cnt`` the fragment-level
    cardinality estimate; ``meta_triples`` the number of metadata/control
    triples the page carries (void:triples, hypermedia controls, paging
    links, ...), which the network-load benchmarks charge to dataRecv
    exactly like the paper does.
    """

    data: np.ndarray
    cnt: int
    page: int
    page_size: int
    has_next: bool
    meta_triples: int

    @property
    def triples_received(self) -> int:
        return int(self.data.shape[0]) + self.meta_triples
