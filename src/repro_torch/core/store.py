"""In-memory triple store with HDT-style sorted indexes.

The paper's server queries an RDF-HDT backend: a compressed, in-memory
representation supporting (a) matching-triple streams for a triple pattern
and (b) O(1)-ish cardinality estimates. We reproduce that contract with
three sorted permutations of the dictionary-encoded triple array (SPO,
POS, OSP) and packed-int64 binary search:

* each triple in a given component order is packed into a single int64
  key by the store's :class:`KeyLayout`, one field per column, the
  order's first column highest. Where every term id fits 21 bits the
  fields are the JAX package's ``a << 42 | b << 21 | c``; past that,
  each column's field is offset by the column's least id and is as
  wide as its range, so ids up to 2**31 - 1 key exactly while the three
  ranges fit 63 bits together (the store raises where they do not);
* a pattern with a bound *prefix* of the chosen order maps to one
  contiguous key range -> two ``searchsorted`` calls give the exact match
  range *and* the exact cardinality, mirroring HDT; a bound constant
  outside its column's field maps to the empty range;
* non-prefix bound components (e.g. ``(s, ?, o)``) are resolved by
  scanning the best prefix range with a vectorized mask; the advertised
  cardinality is then an *estimate* (the prefix-range size), which is
  precisely the ``cnt`` estimate with error eps that Definition 2 allows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fragments import FragmentStore
from .metrics import STORE_BUILD
from .rdf import TriplePattern, is_var

# Component orders for the three indexes.
_ORDERS = {
    "spo": (0, 1, 2),
    "pos": (1, 2, 0),
    "osp": (2, 0, 1),
}

# Bits of each field of the narrow layout (the JAX package's key).
NARROW_BITS = 21
# Bits a key may take: an int64 without its sign bit.
KEY_BITS = 63
# The (lo_key, hi_key) of a prefix no row can have: searchsorted puts
# both ends at 0, so every range it bounds is empty.
EMPTY_BOUNDS = (0, -1)


class KeyLayout:
    """How one store packs a row of term ids into one int64 key.

    Each column (subject, predicate, object) has one field: the id less
    the column's ``offsets`` entry, in ``widths`` bits. An index order
    puts its first column's field highest, so an order's keys sort as
    its rows do. :meth:`of` chooses the layout from the data: three
    21-bit fields at offset 0 where every id fits 21 bits (the JAX
    package's ``a << 42 | b << 21 | c``, bit for bit), else per column
    its least id and the bits its range needs.
    """

    def __init__(self, offsets: Tuple[int, int, int],
                 widths: Tuple[int, int, int]) -> None:
        self.offsets = tuple(int(x) for x in offsets)
        self.widths = tuple(int(x) for x in widths)
        if sum(self.widths) > KEY_BITS:
            raise ValueError(
                f"key fields of {self.widths} bits (subject, predicate, "
                f"object) need {sum(self.widths)} bits; an int64 key "
                f"holds {KEY_BITS}")
        self._fields: Dict[str, Tuple[Tuple[int, int, int, int], ...]] = {}
        for name, order in _ORDERS.items():
            shift = sum(self.widths)
            fields = []
            for col in order:
                shift -= self.widths[col]
                fields.append((col, self.offsets[col], shift,
                               self.widths[col]))
            self._fields[name] = tuple(fields)

    @classmethod
    def narrow(cls) -> "KeyLayout":
        return cls((0, 0, 0), (NARROW_BITS,) * 3)

    @classmethod
    def of(cls, triples: np.ndarray) -> "KeyLayout":
        """The layout of the non-negative int ``[N, 3]`` ``triples``."""
        triples = np.asarray(triples).reshape(-1, 3)
        if triples.shape[0] == 0 \
                or int(triples.max()) < (1 << NARROW_BITS):
            return cls.narrow()
        lows = triples.min(axis=0).astype(np.int64)
        highs = triples.max(axis=0).astype(np.int64)
        return cls(tuple(lows), tuple(int(h - lo).bit_length()
                                      for lo, h in zip(lows, highs)))

    def __eq__(self, other) -> bool:
        return isinstance(other, KeyLayout) and \
            (self.offsets, self.widths) == (other.offsets, other.widths)

    def __repr__(self) -> str:
        return f"KeyLayout(offsets={self.offsets}, widths={self.widths})"

    def fields(self, order: str) -> Tuple[Tuple[int, int, int, int], ...]:
        """``(column, offset, shift, width)`` of each field of ``order``'s
        key, first (highest) field first."""
        return self._fields[order]

    def order_widths(self) -> Dict[str, Tuple[int, int, int]]:
        """Each order's field widths, highest field first."""
        return {name: tuple(f[3] for f in fields)
                for name, fields in self._fields.items()}

    def pack(self, rows: np.ndarray, order: str) -> np.ndarray:
        """int64 keys under ``order`` of the int ``[N, 3]`` ``rows``
        (subject, predicate, object columns)."""
        key = np.zeros(rows.shape[0], dtype=np.int64)
        for col, offset, shift, _width in self._fields[order]:
            part = rows[:, col].astype(np.int64)
            if offset:
                part -= offset
            part <<= shift
            key |= part
        return key

    def unpack(self, keys: np.ndarray, order: str,
               dtype=np.int32) -> np.ndarray:
        """The ``[N, 3]`` rows (subject, predicate, object columns) of
        ``order``'s int64 ``keys``: :meth:`pack` undone."""
        rows = np.empty((keys.shape[0], 3), dtype=dtype)
        for col, offset, shift, width in self._fields[order]:
            value = keys >> shift
            value &= (1 << width) - 1
            if offset:
                value += offset
            rows[:, col] = value
        return rows

    def prefix_bounds(self, comps: np.ndarray, order: str, plen: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Inclusive ``(lo_keys, hi_keys)`` of the length-``plen`` bound
        prefix of each pattern row of ``comps`` (int [K, 3]) under
        ``order``: the unbound tail's fields run from 0 to their largest
        value, and a row with a bound constant outside its field gets
        :data:`EMPTY_BOUNDS`. ``searchsorted`` left / right on the
        result gives the exact index interval. The single source of the
        sub-range keys of :meth:`TripleStore.subranges` and the sharded
        planner (``FederatedStore.plan_windows``)."""
        comps = np.asarray(comps, dtype=np.int64).reshape(-1, 3)
        lo = np.zeros(comps.shape[0], dtype=np.int64)
        hi = np.zeros(comps.shape[0], dtype=np.int64)
        inside = np.ones(comps.shape[0], dtype=bool)
        for i, (col, offset, shift, width) in enumerate(self._fields[order]):
            top = (1 << width) - 1
            if i < plen:
                value = comps[:, col] - offset
                inside &= (value >= 0) & (value <= top)
                value = np.where(inside, value, 0) << shift
                lo |= value
                hi |= value
            else:
                hi |= top << shift
        lo[~inside], hi[~inside] = EMPTY_BOUNDS
        return lo, hi

    def pattern_bounds(self, tp: TriplePattern, order: str
                       ) -> Tuple[int, int]:
        """``(lo_key, hi_key)`` of ``tp``'s bound prefix under ``order``."""
        comps = tp.as_tuple()
        plen = 0
        for col in _ORDERS[order]:
            if is_var(comps[col]):
                break
            plen += 1
        lo, hi = self.prefix_bounds(
            np.asarray([[c if not is_var(c) else 0 for c in comps]]),
            order, plen)
        return int(lo[0]), int(hi[0])


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
        clock = STORE_BUILD.phases("host")
        triples = np.asarray(triples, dtype=np.int32).reshape(-1, 3)
        if int(triples.min(initial=0)) < 0:
            raise ValueError("data triples must not contain variables")
        self.layout = KeyLayout.of(triples)
        STORE_BUILD.widths = self.layout.order_widths()
        # Set semantics: an RDF graph is a set of triples. The distinct
        # rows in SPO key order are np.unique(axis=0)'s rows in its
        # order, and the SPO index is then the identity. A key holds its
        # whole row, so rows already sorted and distinct (a loaded
        # store's) are kept as they are, and the other orders' keys are
        # distinct: any sort gives their one permutation.
        keys = self.layout.pack(triples, "spo")
        if not (keys[1:] > keys[:-1]).all():
            perm = np.argsort(keys, kind="stable")
            keys = keys[perm]
            first = np.ones(keys.shape[0], dtype=bool)
            first[1:] = keys[1:] != keys[:-1]
            triples = triples[perm[first]]
            keys = keys[first]
            del perm, first
        self.triples = triples
        self._indexes = {"spo": _Index(
            _ORDERS["spo"], keys,
            np.arange(triples.shape[0], dtype=np.int32))}
        clock.mark("dedup")
        for name, order in _ORDERS.items():
            if name == "spo":
                continue
            keys = self.layout.pack(triples, name)
            perm = np.argsort(keys).astype(np.int32)
            self._indexes[name] = _Index(order, keys[perm], perm)
            clock.mark(name)
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
        lo_key, hi_key = self.layout.pattern_bounds(tp, name)
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
            comps = np.asarray([p.as_tuple() for p in pats],
                               dtype=np.int64)               # [K, 3]
            lo_keys, hi_keys = self.layout.prefix_bounds(comps, name, plen)
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
        lo, hi = self.layout.prefix_bounds(
            np.asarray(triple, dtype=np.int64).reshape(1, 3), "spo", 3)
        key = int(lo[0])
        if key > int(hi[0]):
            return False
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
