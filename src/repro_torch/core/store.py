"""In-memory triple store with HDT-style sorted indexes.

The paper's server queries an RDF-HDT backend: a compressed, in-memory
representation supporting (a) matching-triple streams for a triple pattern
and (b) O(1)-ish cardinality estimates. We reproduce that contract with
three sorted permutations of the dictionary-encoded triple array (SPO,
POS, OSP) and packed-int64 binary search:

* each triple ``(a, b, c)`` in a given component order is packed into a
  single int64 key ``a << 42 | b << 21 | c`` (21 bits per component,
  i.e. up to 2,097,151 distinct terms — far above our workloads);
* a pattern with a bound *prefix* of the chosen order maps to one
  contiguous key range -> two ``searchsorted`` calls give the exact match
  range *and* the exact cardinality, mirroring HDT;
* non-prefix bound components (e.g. ``(s, ?, o)``) are resolved by
  scanning the best prefix range with a vectorized mask; the advertised
  cardinality is then an *estimate* (the prefix-range size), which is
  precisely the ``cnt`` estimate with error eps that Definition 2 allows.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .fragments import FragmentStore
from .rdf import TriplePattern, is_var

_BITS = 21
_MAX_ID = (1 << _BITS) - 1

# Component orders for the three indexes.
_ORDERS = {
    "spo": (0, 1, 2),
    "pos": (1, 2, 0),
    "osp": (2, 0, 1),
}


def _pack(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    return (
        a.astype(np.int64) << (2 * _BITS)
        | b.astype(np.int64) << _BITS
        | c.astype(np.int64)
    )


@dataclasses.dataclass
class _Index:
    order: Tuple[int, int, int]  # component order, e.g. (1, 2, 0) for POS
    keys: np.ndarray             # int64 [N], sorted packed keys
    perm: np.ndarray             # int32 [N], perm into the triple array


@dataclasses.dataclass
class CandidateRange:
    """The contiguous prefix range a pattern maps to in its chosen index.

    This is the store's device-facing contract: ``(index, lo, hi,
    prefix_len)`` identify the range for paging/accounting, and every
    triple matching the pattern -- or any instantiation of it -- lies in
    this range. The range is *lazy*: holding a ``CandidateRange`` (e.g.
    in the store's range memo) costs O(1), not O(hi - lo).

    ``window(page, size)`` gathers only ``perm[lo + page*size : ...]``
    -- the true range->page index: a page>0 request materializes just
    its window, never the whole range; gathered windows register as
    *pages* of the owning store's range fragment store (one bounded
    page layer, evicted coherently with the range entry itself), so a
    repeated window read never re-gathers. ``triples`` materializes the
    full block (index order, hence deterministic) for consumers that
    stream it in one HBM pass (the single-host bind-join kernel) and
    caches it, so repeated full reads through the memo gather once.
    """

    index: str                   # index name: "spo" | "pos" | "osp"
    lo: int                      # range start in the index
    hi: int                      # range end (exclusive)
    prefix_len: int              # bound components covered by the prefix
    _store_triples: np.ndarray = dataclasses.field(repr=False, default=None)
    _perm: np.ndarray = dataclasses.field(repr=False, default=None)
    _materialized: Optional[np.ndarray] = dataclasses.field(
        repr=False, default=None)
    # page-layer hookup: (fragment store, fragment key) of the memo
    # entry this range lives in -- set by TripleStore.candidate_range
    _fragments: Optional[object] = dataclasses.field(
        repr=False, default=None)
    _key: Optional[tuple] = dataclasses.field(repr=False, default=None)

    def __len__(self) -> int:
        return self.hi - self.lo

    def window(self, page: int, size: int) -> np.ndarray:
        """Rows ``[lo + page*size, min(lo + (page+1)*size, hi))`` of the
        range, int32 [<=size, 3], gathered without materializing the
        rest (unless the full block or this exact window is already
        cached)."""
        a = self.lo + page * size
        b = min(a + size, self.hi)
        if a >= b:
            return np.empty((0, 3), dtype=np.int32)
        if self._materialized is not None:
            return self._materialized[a - self.lo : b - self.lo]
        page_key = None
        if self._fragments is not None:
            page_key = (*self._key, (page, size))
            got = self._fragments.http_get(page_key)
            if got is not None:
                return got
        rows = self._store_triples[self._perm[a:b]]
        if page_key is not None:
            self._fragments.http_put(page_key, rows)
        return rows

    @property
    def triples(self) -> np.ndarray:
        """Full materialized block, int32 [hi - lo, 3] (cached)."""
        if self._materialized is None:
            self._materialized = \
                self._store_triples[self._perm[self.lo:self.hi]]
        return self._materialized

    @property
    def materialized_rows(self) -> int:
        """Rows this range actually pins (memo accounting unit)."""
        return 0 if self._materialized is None else len(self)

    @property
    def components(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Structure-of-arrays view (s, p, o) -- the kernel input layout."""
        t = self.triples
        return t[:, 0], t[:, 1], t[:, 2]


def prefix_interval_keys(comps: np.ndarray, order: Tuple[int, int, int],
                         plen: int) -> Tuple[np.ndarray, np.ndarray]:
    """Packed ``(lo_keys, hi_keys)`` of the length-``plen`` bound prefix
    of each pattern row in ``comps`` (int64 [K, 3]) under ``order``.

    The single source of the sub-range key derivation used by
    :meth:`TripleStore.subranges`.
    Unbound tail positions fill with 0 / ``_MAX_ID``; ``searchsorted``
    left/right on the result gives the exact index interval.
    """
    lo_cols, hi_cols = [], []
    for i in range(3):
        if i < plen:
            col = comps[:, order[i]]
            lo_cols.append(col)
            hi_cols.append(col)
        else:
            lo_cols.append(np.zeros(comps.shape[0], np.int64))
            hi_cols.append(np.full(comps.shape[0], _MAX_ID, np.int64))
    return (_pack(lo_cols[0], lo_cols[1], lo_cols[2]),
            _pack(hi_cols[0], hi_cols[1], hi_cols[2]))


def merge_spans(bounds: np.ndarray) -> np.ndarray:
    """Merge per-binding ``(lo, hi)`` intervals into disjoint union spans.

    The union-merge rule of the pruned read path (docs/pruning.md):
    drop empty intervals, sort by ``lo``, and coalesce overlapping *or
    adjacent* intervals -- the result is the minimal sorted sequence of
    disjoint ``[lo, hi)`` spans covering exactly the union. Disjointness
    is what makes the pruned candidate block duplicate-free within one
    index (each row position appears in at most one span).
    """
    bounds = np.asarray(bounds, dtype=np.int64).reshape(-1, 2)
    bounds = bounds[bounds[:, 1] > bounds[:, 0]]
    if bounds.shape[0] == 0:
        return np.empty((0, 2), dtype=np.int64)
    bounds = bounds[np.argsort(bounds[:, 0], kind="stable")]
    merged: List[List[int]] = [[int(bounds[0, 0]), int(bounds[0, 1])]]
    for lo, hi in bounds[1:]:
        if lo <= merged[-1][1]:                 # overlap or adjacency
            merged[-1][1] = max(merged[-1][1], int(hi))
        else:
            merged.append([int(lo), int(hi)])
    return np.asarray(merged, dtype=np.int64)


@dataclasses.dataclass
class SpanGroup:
    """Sub-ranges of one index for one uniform instantiation shape."""

    index: str                   # index name: "spo" | "pos" | "osp"
    prefix_len: int              # bound prefix length of the shape
    bounds: np.ndarray           # int64 [K, 2] per-binding (lo, hi)
    spans: np.ndarray            # int64 [S, 2] merged disjoint union

    @property
    def rows(self) -> int:
        if self.spans.shape[0] == 0:
            return 0
        return int((self.spans[:, 1] - self.spans[:, 0]).sum())


@dataclasses.dataclass
class SubRanges:
    """Omega-restricted candidate sub-ranges for one request.

    Each distinct binding attached to a brTPF request instantiates a
    *more-bound* pattern whose matches occupy a contiguous key range of
    some index order -- so the union of those per-binding ``(lo, hi)``
    sub-ranges covers every triple that can join with the attached
    intermediate result, and everything outside the union is provably
    join-irrelevant. ``groups`` holds one :class:`SpanGroup` per uniform
    instantiation shape (mappings with different bound-variable sets
    instantiate differently-shaped patterns, each with its own best
    index); ``rows`` is the pre-dedup union size, the quantity selector
    backends compare against the full prefix range to decide whether
    pruning pays.
    """

    pattern: Tuple[int, int, int]
    groups: List[SpanGroup]

    @property
    def rows(self) -> int:
        return sum(g.rows for g in self.groups)

    def page_key(self) -> tuple:
        """Stable page-layer key for the pruned row set: pruned
        selections memoize independently of full-range reads (and of
        each other -- distinct span unions get distinct keys)."""
        return ("pruned",) + tuple(
            (g.index, g.spans.tobytes()) for g in self.groups)


class TripleStore:
    """Sorted-index triple store over ``int32 [N, 3]`` triples."""

    def __init__(self, triples: np.ndarray) -> None:
        triples = np.asarray(triples, dtype=np.int32).reshape(-1, 3)
        # Set semantics: an RDF graph is a set of triples.
        if triples.shape[0] > 0:
            triples = np.unique(triples, axis=0)
            if int(triples.max(initial=0)) > _MAX_ID:
                raise ValueError("term id exceeds 21-bit packing limit")
            if int(triples.min(initial=0)) < 0:
                raise ValueError("data triples must not contain variables")
        self.triples = triples
        self._indexes = {}
        for name, order in _ORDERS.items():
            keys = _pack(
                triples[:, order[0]], triples[:, order[1]], triples[:, order[2]]
            )
            perm = np.argsort(keys, kind="stable").astype(np.int32)
            self._indexes[name] = _Index(order, keys[perm], perm)
        # Per-pattern candidate-range memo (ROADMAP "Kernel-path TPF
        # paging"): materializing ``triples[perm[lo:hi]]`` is the
        # expensive part of a range read -- a gather over a range that
        # can span the whole store. Ranges are lazy, so a memo entry is
        # O(1) until some consumer materializes its full block; the
        # store is immutable, so the memo never goes stale; the server
        # evicts it coherently with its unified fragment store (its
        # ``on_release`` hook calls :meth:`evict_candidate_range`).
        # The memo itself is a FragmentStore data layer keyed
        # ``(pattern_tuple, None)`` with a materialized-rows weigher:
        # broad patterns can materialize near-store-sized copies, so
        # the memo is bounded by retained ROWS as well as entries (64
        # low-selectivity ranges must not pin ~64x the store; the
        # newest entry is always kept).
        # page_capacity bounds retained window slices (CandidateRange
        # .window registers its gathers as pages of this store).
        self._ranges = FragmentStore(
            memo_capacity=64,
            page_capacity=256,
            max_rows=max(4 * triples.shape[0], 4096),
            weigh=lambda rng: rng.materialized_rows)

    def __len__(self) -> int:
        return int(self.triples.shape[0])

    @property
    def num_terms(self) -> int:
        return int(self.triples.max(initial=-1)) + 1

    # -- range-memo accounting (delegates to the fragment store) -------------

    @property
    def range_memo_hits(self) -> int:
        return self._ranges.hits

    @property
    def range_memo_misses(self) -> int:
        return self._ranges.misses

    @property
    def range_memo_cap(self) -> int:
        return self._ranges.memo_capacity

    @range_memo_cap.setter
    def range_memo_cap(self, value: int) -> None:
        self._ranges.memo_capacity = int(value)

    @property
    def range_memo_max_rows(self) -> Optional[int]:
        return self._ranges.max_rows

    @range_memo_max_rows.setter
    def range_memo_max_rows(self, value: Optional[int]) -> None:
        self._ranges.max_rows = value

    @property
    def _range_memo(self) -> dict:
        """{pattern_tuple -> CandidateRange} view of the memo."""
        return {key[0]: rng
                for key, rng in self._ranges.data_payloads().items()}

    # -- index selection ----------------------------------------------------

    @staticmethod
    def _choose_index(tp: TriplePattern) -> Tuple[str, int]:
        """Pick the index whose order has the longest bound prefix.

        Returns (index_name, prefix_len).
        """
        bound = [not is_var(c) for c in tp.as_tuple()]
        best_name, best_len = "spo", 0
        for name, order in _ORDERS.items():
            plen = 0
            for comp in order:
                if bound[comp]:
                    plen += 1
                else:
                    break
            if plen > best_len:
                best_name, best_len = name, plen
        return best_name, best_len

    def _prefix_range(self, tp: TriplePattern) -> Tuple[str, int, int, int]:
        """(index, lo, hi, prefix_len) of the candidate range for ``tp``."""
        name, plen = self._choose_index(tp)
        idx = self._indexes[name]
        if plen == 0:
            return name, 0, int(idx.keys.shape[0]), 0
        comps = tp.as_tuple()
        vals = [comps[idx.order[i]] for i in range(plen)]
        padded_lo = vals + [0] * (3 - plen)
        lo_key = int(
            _pack(np.int64(padded_lo[0]), np.int64(padded_lo[1]),
                  np.int64(padded_lo[2]))
        )
        padded_hi = vals + [_MAX_ID] * (3 - plen)
        # Python-int arithmetic: the all-MAX key is int64-max, +1 must not
        # wrap. searchsorted accepts python ints beyond int64 via 'right'
        # side on the exact hi key instead.
        hi_key = int(
            _pack(np.int64(padded_hi[0]), np.int64(padded_hi[1]),
                  np.int64(padded_hi[2]))
        )
        lo = int(np.searchsorted(idx.keys, lo_key, side="left"))
        hi = int(np.searchsorted(idx.keys, hi_key, side="right"))
        return name, lo, hi, plen

    # -- public API (the HDT-backend contract) ------------------------------

    def candidate_range(self, tp: TriplePattern,
                        memoize: bool = True) -> CandidateRange:
        """Lazy candidate range for ``tp`` (kernel / windowed input).

        The chosen index's bound-prefix range, in index order. Supersets
        the exact match set (non-prefix bound components and
        repeated-variable constraints are *not* applied here -- the
        bind-join/tpf-match kernels resolve those on device). No rows
        are gathered until ``.window()`` or ``.triples`` is read.

        ``memoize=False`` is the *probe* path (``cardinality`` fallback
        scans and other one-shot estimates): a memoized range is still
        reused -- and counted as a hit -- but an absent one is built
        without inserting a memo entry and without charging a miss, so
        probe traffic can neither churn the LRU nor distort the memo's
        hit/miss accounting (the streaming read paths are what the
        range-memo metrics describe).
        """
        # Rows are pinned lazily (a consumer may have materialized
        # since the last access), so the fragment store re-enforces the
        # row bound on hits too -- the just-hit entry is LRU-newest,
        # never popped.
        key = (tp.as_tuple(), None)
        memo = self._ranges.get_data(key, count_miss=memoize)
        if memo is not None:
            return memo
        name, lo, hi, plen = self._prefix_range(tp)
        idx = self._indexes[name]
        rng = CandidateRange(index=name, lo=lo, hi=hi, prefix_len=plen,
                             _store_triples=self.triples, _perm=idx.perm,
                             _fragments=self._ranges if memoize else None,
                             _key=key if memoize else None)
        if memoize:
            self._ranges.put_data(key, rng)
        return rng

    def evict_candidate_range(self, pattern_tuple: Tuple[int, int, int]
                              ) -> bool:
        """Drop a memoized candidate range (coherence hook fired by the
        server's fragment store when a pattern's last live fragment is
        evicted). Returns True if present."""
        return self._ranges.evict((pattern_tuple, None))

    # -- Omega-restricted candidate pruning (docs/pruning.md) ----------------

    def subranges(self, tp: TriplePattern, omega: Optional[np.ndarray] = None,
                  insts: Optional[List[TriplePattern]] = None,
                  ) -> Optional[SubRanges]:
        """Per-binding candidate sub-ranges for an Omega-restricted read.

        Each distinct binding value instantiates a more-bound pattern;
        when the instantiated shape has a longer bound prefix in some
        index order, its matches occupy one contiguous key range there.
        This batches the derivation: the packed ``(lo, hi)`` prefix keys
        of ALL distinct bindings of a shape are searchsorted against the
        index's int64 key array in one vectorized call each, and the
        resulting intervals are union-merged into disjoint spans
        (:func:`merge_spans`). Streaming only the merged union is exact:
        every triple matching any instantiated pattern lies inside that
        pattern's sub-range, so rows outside the union are guaranteed
        join-irrelevant (the paper's "only triples that contribute to
        the join" server promise, enforced on the read side).

        ``insts`` may carry the already-instantiated (deduped) pattern
        list -- the server computes it for lookup accounting. Returns
        ``None`` when pruning cannot narrow anything: no instantiation
        binds a prefix position (e.g. empty Omega, or mappings that
        leave the pattern's shape unchanged).
        """
        if insts is None:
            from .selectors import instantiate_patterns
            insts = instantiate_patterns(tp, omega)
        if not insts:
            return None
        shapes: "dict[tuple, List[TriplePattern]]" = {}
        for p in insts:
            mask = tuple(is_var(c) for c in p.as_tuple())
            shapes.setdefault(mask, []).append(p)
        groups: List[SpanGroup] = []
        for pats in shapes.values():
            name, plen = self._choose_index(pats[0])
            if plen == 0:
                # Some instantiation is fully unbound: its sub-range is
                # the whole store, nothing can be pruned.
                return None
            order = self._indexes[name].order
            comps = np.asarray([p.as_tuple() for p in pats],
                               dtype=np.int64)               # [K, 3]
            lo_keys, hi_keys = prefix_interval_keys(comps, order, plen)
            keys = self._indexes[name].keys
            los = np.searchsorted(keys, lo_keys, side="left")
            his = np.searchsorted(keys, hi_keys, side="right")
            bounds = np.stack([los, his], axis=1).astype(np.int64)
            groups.append(SpanGroup(index=name, prefix_len=plen,
                                    bounds=bounds,
                                    spans=merge_spans(bounds)))
        return SubRanges(pattern=tp.as_tuple(), groups=groups)

    def gather_subranges(self, sr: SubRanges) -> np.ndarray:
        """Materialize the pruned candidate row set, int32 [U, 3].

        One gather per span group; span disjointness within an index
        guarantees no duplicates per group, and a cross-group
        ``np.unique`` dedups the (rare) multi-shape case where two
        indexes surface the same physical triple -- the selector
        epilogues require each candidate triple to appear exactly once.
        Row order is arbitrary by contract (the selectors' stream-order
        epilogue re-sorts kept rows), which is what lets the pruned and
        full-range paths stay byte-identical.

        Gathered row sets register as pages of the owning pattern's
        range-memo entry (keyed by :meth:`SubRanges.page_key`), so a
        repeated pruned read never re-gathers and is evicted coherently
        with the pattern's other fragments.
        """
        key = (sr.pattern, None, sr.page_key())
        got = self._ranges.http_get(key)
        if got is not None:
            return got
        blocks = []
        for g in sr.groups:
            if g.spans.shape[0] == 0:
                continue
            perm = self._indexes[g.index].perm
            idxs = np.concatenate([perm[lo:hi] for lo, hi in g.spans])
            blocks.append(self.triples[idxs])
        if not blocks:
            rows = np.empty((0, 3), dtype=np.int32)
        else:
            rows = np.concatenate(blocks, axis=0)
            if len(sr.groups) > 1:
                rows = np.unique(rows, axis=0)
        self._ranges.http_put(key, rows)
        return rows

    def cardinality(self, tp: TriplePattern) -> int:
        """Cardinality estimate ``cnt`` (Definition 2).

        Exact when the bound components form a prefix of some index order
        (always true for 0, 1 bound, any 2-adjacent, or all 3); an upper
        bound (prefix-range size) otherwise. Satisfies cnt = 0 <=> empty
        for prefix patterns; for scan patterns cnt = 0 still implies empty.
        """
        _, lo, hi, plen = self._prefix_range(tp)
        est = hi - lo
        if est == 0:
            return 0
        if plen == tp.num_bound():
            # Bound components fully covered by the prefix: exact, unless
            # the pattern has a repeated variable (e.g. (?x, p, ?x)).
            if len(tp.variables()) == 3 - plen:
                return est
        # Fall back to an exact scan count (cheap at our scales; a real
        # HDT backend would return `est` here -- Definition 2 allows it).
        # Probe path: reuse a memoized range (counted as a hit) but
        # never insert/charge one -- cardinality estimates must not
        # churn the streaming memo.
        return int(self.match(tp, memoize=False).shape[0])

    def match(self, tp: TriplePattern,
              memoize: bool = True) -> np.ndarray:
        """All matching triples for ``tp``, int32 [M, 3], sorted order
        of the chosen index (deterministic for paging).

        Routed through :meth:`candidate_range` so a range the memo
        already holds is not re-gathered (``cardinality``'s fallback
        scan previously double-paid the gather) and the reuse is counted
        in ``range_memo_hits``.
        """
        cand = self.candidate_range(tp, memoize=memoize).triples
        if cand.shape[0] == 0:
            return cand
        mask = np.ones(cand.shape[0], dtype=bool)
        # Residual constant constraints not covered by the prefix.
        for comp, c in enumerate(tp.as_tuple()):
            if not is_var(c):
                mask &= cand[:, comp] == c
        # Repeated-variable constraints (e.g. (?x, p, ?x)).
        comps = tp.as_tuple()
        for i in range(3):
            for j in range(i + 1, 3):
                if is_var(comps[i]) and comps[i] == comps[j]:
                    mask &= cand[:, i] == cand[:, j]
        return cand[mask]

    def match_range(self, tp: TriplePattern, offset: int,
                    limit: int) -> Tuple[np.ndarray, int]:
        """Paged matching: (page_triples, total_count).

        Deterministic given (tp, offset, limit) -- required for paging.
        """
        m = self.match(tp)
        return m[offset : offset + limit], int(m.shape[0])

    def contains(self, triple: np.ndarray) -> bool:
        t = np.asarray(triple, dtype=np.int32)
        key = int(_pack(t[0:1], t[1:2], t[2:3])[0])
        idx = self._indexes["spo"]
        pos = int(np.searchsorted(idx.keys, key, side="left"))
        return pos < idx.keys.shape[0] and int(idx.keys[pos]) == key


def store_from_ntriples(lines, dictionary) -> TripleStore:
    """Tiny N-Triples-ish loader for tests/examples: 's p o' per line."""
    rows = []
    for line in lines:
        line = line.strip().rstrip(".").strip()
        if not line or line.startswith("#"):
            continue
        s, p, o = line.split()[:3]
        rows.append([dictionary.intern(s), dictionary.intern(p),
                     dictionary.intern(o)])
    return TripleStore(np.asarray(rows, dtype=np.int32).reshape(-1, 3))
