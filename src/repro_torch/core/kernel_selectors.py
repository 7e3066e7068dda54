"""Kernel-backed bindings-restricted selectors (the server hot path).

The port of ``repro.core.kernel_selectors``. ``brtpf_select_with_cnt``
in ``selectors.py`` evaluates the section-4.1 server algorithm the way
the paper's Java servlet does: one backend index probe + stream per
instantiated pattern. This module is the same selector inverted for the
accelerator: the store exposes the pattern's contiguous index range as
one packed candidate block (:meth:`TripleStore.candidate_range`), the
hand-written CUDA bind-join kernel streams that block *once* against
every instantiated pattern, and a compaction of the kept cells plus a
small host reorder produce a fragment that is byte-identical to
the numpy selector's -- same data-triple sequence, same ordering, same
Definition-2 ``cnt`` estimate, and the same ``LaunchRecord`` geometry as
the JAX package's selector (``tests/test_torch_selectors.py``).

The selector runs on ``device`` (CUDA unless the caller asks for the
CPU, where the kernels' plain PyTorch versions run). Candidate blocks
still live on the host store and are copied to the device per launch.

Cross-request batching: concurrent brTPF requests for the *same* triple
pattern share the same candidate range, so their (padded) pattern sets
ride one grouped kernel launch -- one pass over the candidates for G
requests instead of G passes. ``BrTPFServer.handle_batch`` feeds this
path; heterogeneous batches ride one fused launch (``select_fused``).

Omega-restricted pruning (docs/pruning.md): when the attached mappings
instantiate more-bound shapes, the launch streams the merged union of
their per-binding index sub-ranges (``TripleStore.subranges``) instead
of the full prefix range. Below ``fast_path_rows`` post-pruning rows
the selection skips the kernel entirely (``select_block_numpy``).

Why parity holds despite the kernel's flat wildcard grid:

* every triple matching an instantiated pattern of ``tp`` also matches
  ``tp``, so ``candidate_range(tp)`` covers all per-pattern streams --
  and the pruned sub-range union covers them by construction;
* repeated-variable constraints are shared by *all* instantiations, so
  conjoining the base pattern's equality flags (``tpf_match``'s test,
  run in the grouped kernel's prologue) restores exact semantics for
  every pattern at once;
* on rows passing those flags, grid-match == exact match per pattern,
  so the kernel's first-match index reproduces the numpy selector's
  first-occurrence dedup and its match count reproduces ``cnt``;
* within a stream, ``store.match(p)`` order is ascending packed key
  under p's chosen index -- recomputable on host for the (small) kept
  set, giving the exact concatenation order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .fragments import FragmentStore, fragment_key
from .metrics import CudaWork
from .rdf import TriplePattern, is_var
from . import trace as _trace
from .selectors import instantiate_patterns
from .store import KeyLayout, TripleStore

# Candidate blocks are padded to power-of-two multiples of the kernel's
# candidate tile: the JAX package's geometry (it bounds that package's
# jit cache), kept so that LaunchRecords agree.
_MIN_BUCKET = 1024

# Shared zero-row fragment payload (zero-size, never mutated).
_EMPTY = np.empty((0, 3), dtype=np.int32)

# Cross-pattern fusion capacity caps (docs/fusion.md), the JAX package's
# values: a fused launch that would exceed any of them falls back to
# per-group launches. Kept equal so that LaunchRecords agree. All
# power-of-two (KL004).
MAX_FUSED_SEGMENTS = 16      # segments sharing one launch
MAX_FUSED_SLOTS = 32768      # flat pattern slot table (S * G * Mp)
MAX_FUSED_STREAM = 131072    # concatenated candidate rows

# Tile size of the JAX package's fused launches: each segment's candidate
# block is tile-aligned independently. The port's kernel reads each
# segment's rows unaligned; the tile stays the geometry of the fusion
# ceilings and of the fused LaunchRecord's cand_streamed.
FUSED_BT = 256
assert FUSED_BT == kops.DEFAULT_FUSED_BT


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class FusedSegment:
    """One segment of a fused cross-pattern launch.

    A segment is what ``select_same_pattern`` serves alone today: one
    triple pattern plus G request groups (each an Omega or None). The
    fused path concatenates every segment's pruned candidate union into
    one stream and resolves per-segment slot tables inside the kernel.

    ``count_only`` marks a count-probe segment: its groups only need the
    Definition-2 ``cnt``, so the launch skips the gather/stream epilogue
    for it and the fragment carries no data triples.

    ``depends_on`` declares that this segment's Omega derives from the
    output of another in-flight segment (by index into the fused batch).
    Fusion legality is conservative: any declared dependency refuses to
    fuse and falls back to per-group launches, in the spirit of DaCe's
    state-fusion tests -- only provably independent work units share a
    launch. Batched server requests are independent by construction
    (each arrives with its Omega fully materialized), so the server
    never sets this; planners that pipeline bind-join rounds must.
    """

    tp: TriplePattern
    omegas: List[Optional[np.ndarray]]
    patterns: Optional[List[List[TriplePattern]]] = None
    count_only: bool = False
    depends_on: Tuple[int, ...] = ()


def fusion_legality(segments: Sequence[FusedSegment], *,
                    stream_rows: int, slot_table: int,
                    max_segments: int = MAX_FUSED_SEGMENTS,
                    max_slots: int = MAX_FUSED_SLOTS,
                    max_stream: int = MAX_FUSED_STREAM) -> Optional[str]:
    """Decide whether a set of segments may share one fused launch.

    Returns None when fusion is legal, else a human-readable refusal
    reason (the caller falls back to per-group launches and the reason
    is surfaced in logs/tests). Explicit and conservative: dependencies
    forbid fusion outright, and capacity ceilings bound the slot table,
    the candidate stream, and the segment count.
    """
    if any(seg.depends_on for seg in segments):
        return "dependent segments: an Omega derives from an in-flight output"
    if len(segments) > max_segments:
        return f"segment count {len(segments)} exceeds {max_segments}"
    if slot_table > max_slots:
        return f"slot table {slot_table} exceeds {max_slots}"
    if stream_rows > max_stream:
        return f"candidate stream {stream_rows} exceeds {max_stream}"
    return None


def grouped_results(mask, first, cnt, groups: int, count_only: bool,
                    payload=None, seg_of_page=None, segments: int = 1
                    ) -> Tuple[np.ndarray, List[List[Tuple]]]:
    """Host side of one windowed grouped or fused launch: one compaction
    and one device-to-host copy of everything the host needs.

    ``mask`` uint8 ``[P, S, G, W]``, ``first`` int32 and ``cnt`` int64
    ``[P, S, G]`` as ``kops.bindjoin_grouped_cuda`` (or, with
    ``seg_of_page``, the fused kernel's int32 ``[P]`` page segments on the
    device, ``kops.bindjoin_fused_cuda``) returns them. Returns the
    Definition-2 ``cnt`` of the first ``groups`` groups of each of the
    ``segments`` segments, int64 ``[segments, groups]``, summed over
    their pages and shards and, unless ``count_only`` (no compaction at
    all), per segment and group a pair: the int32 ``[K, C]`` columns
    ``payload`` computes on the device from the kept cells' ``(p, s, g,
    r)`` indices (int64 ``[K, 4]``), and the cells' first matching slots,
    each in page, shard, row order. The copy is int32: the int64 ``cnt``
    travels as pairs of int32 words, and a cell's segment, group and
    first matching slot as one word, ``(first * segments + seg) * G +
    g``.
    """
    cnt = cnt[..., :groups]
    if seg_of_page is None:
        cnt = cnt.sum(dim=(0, 1))[None]
    else:
        # a dead page keeps nothing: its cnt is 0 wherever it adds
        cnt = torch.zeros((segments, groups), dtype=torch.int64,
                          device=cnt.device).index_add_(
            0, seg_of_page.clamp(min=0).long(), cnt.sum(dim=1))
    if count_only:
        return cnt.cpu().numpy(), []
    g_all = mask.shape[2]
    cells = torch.nonzero(mask)                      # (K, 4), row-major
    key = first[tuple(cells.T)]
    if seg_of_page is not None:
        key = key * segments + seg_of_page[cells[:, 0]]
    key = key * g_all + cells[:, 2]
    cols = torch.cat([payload(cells), key[:, None]], dim=1)
    host = torch.cat([cnt.reshape(-1).view(torch.int32),
                      cols.to(torch.int32).reshape(-1)]).cpu().numpy()
    n_cnt = 2 * segments * groups
    cols_h = host[n_cnt:].reshape(-1, cols.shape[1])
    rest, group = np.divmod(cols_h[:, -1], g_all)
    first_h, seg = np.divmod(rest, segments)
    # stable: each (segment, group) keeps the page, shard, row order
    cell = seg * groups + group
    order = np.argsort(cell, kind="stable")
    bounds = np.searchsorted(cell[order], np.arange(segments * groups + 1))
    cols_h, first_h = cols_h[order, :-1], first_h[order]
    runs = [slice(bounds[c], bounds[c + 1])
            for c in range(segments * groups)]
    kept = [[(cols_h[run], first_h[run])
             for run in runs[si * groups:(si + 1) * groups]]
            for si in range(segments)]
    return host[:n_cnt].view(np.int64).reshape(segments, groups), kept


def rows_back(kept: List[List[Tuple]]) -> int:
    """The kept rows that :func:`grouped_results` copied back in
    ``kept``."""
    return sum(cols.shape[0] for seg in kept for cols, _first in seg)


@dataclasses.dataclass
class LaunchRecord:
    """Geometry/accounting of one grouped kernel launch.

    The single accounting surface for every accelerated selector path:
    :class:`KernelSelector` records one per grouped or fused bind-join
    launch (``cand_streamed`` = padded range bucket), and
    :class:`~repro_torch.core.federation.ShardedSelector` one per window
    page or routed round (``cand_streamed`` = the rows one shard streams,
    ``reclaimed_rows`` for sub-window compaction) and one per fused
    round (``segments`` = the round's active segments). The fields are
    the JAX package's, so that both packages' records compare field by
    field; what the CUDA kernels did beyond them (launches per chunk,
    live slots) is the selectors' :class:`~repro_torch.core.metrics.CudaWork`.

    ``skipped=True`` records a launch that was *avoided* because the
    requested fragment was already resident in the unified fragment
    store (``core/fragments.py``): no candidates were streamed, no
    pattern slots paid, and the server's launch budget must not charge
    it (``Counters.launches_skipped`` counts these instead).

    ``pruned=True`` marks a launch whose candidate stream was the
    Omega-restricted sub-range union instead of the full prefix range
    (``cand_full`` records what the unpruned stream would have been).
    ``fast_path=True`` records a small-work decision: the (post-pruning)
    candidate row count fell below the selector's ``fast_path_rows``
    threshold, so the groups were served by the numpy oracle with no
    kernel launch at all -- the server charges it to
    ``Counters.fast_path_selects``, never to the launch budget.

    ``segments`` counts the distinct triple-pattern segments the launch
    served: 1 for the classic same-pattern grouped launch, >= 2 for a
    cross-pattern fused launch (docs/fusion.md) whose candidate stream
    concatenates every segment's pruned union. ``reclaimed_rows``
    records sub-window compaction on the sharded path: rows inside a
    shard window that ``merge_spans`` proved dead and the launch
    therefore never streamed.
    """

    cand_streamed: int      # padded candidates streamed once (T)
    pat_slots: int          # padded pattern slots across groups (G * Mp)
    groups: int             # requests served by the launch
    skipped: bool = False   # avoided entirely: fragment-store residency
    pruned: bool = False    # streamed the sub-range union, not the range
    cand_full: int = 0      # unpruned stream size (pruning accounting)
    fast_path: bool = False  # routed to the numpy oracle (small work)
    segments: int = 1       # distinct pattern segments fused in the launch
    reclaimed_rows: int = 0  # dead sub-window rows compacted away
    # raw (pre-padding) candidate rows behind cand_streamed; 0 means
    # "not tracked, use cand_streamed". The throughput sim re-derives a
    # fused launch's tile-aligned stream from these, since padding
    # granularity differs between solo (shape bucket) and fused
    # (FUSED_BT tiles) launches.
    cand_rows: int = 0
    # raw full-range rows (pre-padding, pre-pruning): the ceiling the
    # stream flips to when a batch's combined sub-range union stops
    # paying (``pruned`` goes False); lets the sim cap its additive
    # union estimate at the real range size.
    full_rows: int = 0

    @property
    def cells(self) -> int:
        return self.cand_streamed * self.pat_slots


def marshal_pattern_grid(
    tp: TriplePattern, patterns: Sequence[List[TriplePattern]],
    g_slots: int, m_slots: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode per-request instantiated-pattern lists as kernel inputs.

    Returns (pats int32 [g_slots, m_slots, 3] with -1 wildcards,
    valid int32 [g_slots, m_slots], base_vec int32 [8] carrying the
    base pattern's components + repeated-variable equality flags).
    Shared by the single-host kernel selector and the sharded windowed
    selector so the two backends cannot drift in how they encode a
    request (``g_slots``/``m_slots`` are each caller's padded grid).
    """
    pats = np.full((g_slots, m_slots, 3), -1, dtype=np.int32)
    valid = np.zeros((g_slots, m_slots), dtype=np.int32)
    for gi, insts in enumerate(patterns):
        for mi, p in enumerate(insts):
            pats[gi, mi] = [c if not is_var(c) else -1
                            for c in p.as_tuple()]
            valid[gi, mi] = 1
    comps = tp.as_tuple()
    base_vec = kops.pattern_vec_from(
        tuple(-1 if is_var(c) else c for c in comps),
        eq_sp=int(is_var(comps[0]) and comps[0] == comps[1]),
        eq_so=int(is_var(comps[0]) and comps[0] == comps[2]),
        eq_po=int(is_var(comps[1]) and comps[1] == comps[2]),
    )
    return pats, valid, base_vec


def live_slot_count(valid: np.ndarray) -> int:
    """Slots the windowed kernel's loop visits per row for the slot grid
    ``valid [G, M]``: each group's up to its last valid one (a hole below
    it stays in the loop), summed over the groups."""
    v = np.asarray(valid) != 0
    last = v.shape[-1] - np.argmax(v[..., ::-1], axis=-1)
    return int(np.where(v.any(axis=-1), last, 0).sum())


def stream_order(kept: np.ndarray, first: np.ndarray,
                 insts: List[TriplePattern],
                 layout: KeyLayout) -> np.ndarray:
    """Reorder kept rows into the numpy selector's sequence order.

    The numpy selector concatenates per-pattern match streams in
    pattern order, then dedups keeping first occurrences: a triple
    lands in the stream of the first pattern it matches, and within
    a stream rows ascend by packed key under that pattern's chosen
    index. ``first`` (from the kernel) gives the stream; the packed
    key (the store's ``layout``) is recomputed here for the kept rows
    only. The rows are grouped by stream (a stable sort of ``first``);
    a key holds its whole row, so each stream's keys are sorted in
    place and unpacked into its rows, all at once where every stream
    keys by one index. Shared by the
    single-host kernel selector and the sharded windowed selector --
    it is what makes both byte-identical to the oracle.
    """
    if kept.shape[0] == 0:
        return kept
    counts = np.bincount(first)
    streams = np.flatnonzero(counts)
    counts = counts[streams]
    names = [TripleStore._choose_index(insts[j])[0] for j in streams]
    if len(streams) > 1:
        kept = kept[np.argsort(first, kind="stable")]
    ends = np.cumsum(counts)
    if len(set(names)) == 1:
        keys = layout.pack(kept, names[0])
        for lo, hi in zip(ends - counts, ends):
            keys[lo:hi].sort()
        return layout.unpack(keys, names[0], kept.dtype)
    out = np.empty_like(kept)
    for name, lo, hi in zip(names, ends - counts, ends):
        keys = layout.pack(kept[lo:hi], name)
        keys.sort()
        out[lo:hi] = layout.unpack(keys, name, kept.dtype)
    return out


def consult_fragments(
    fragments: Optional[FragmentStore], tp: TriplePattern,
    omegas: Sequence[Optional[np.ndarray]],
    launches: List[LaunchRecord],
) -> Tuple[List[Optional[Tuple[np.ndarray, int]]], List[int]]:
    """Serve request groups already resident in the unified fragment
    store; return (results-with-resident-filled, live group indices).

    Shared by the single-host and sharded selectors: each resident
    group's launch share is *skipped* -- recorded as a
    ``LaunchRecord(skipped=True)`` plus ``fragments.note_skip()`` --
    and only the live indices proceed to marshalling/launch. Residency
    peeks are non-counting (the server accounts its own memo lookups
    for the same requests); they do bump the entry's LRU position.
    """
    results: List[Optional[Tuple[np.ndarray, int]]] = [None] * len(omegas)
    if fragments is None:
        return results, list(range(len(omegas)))
    live: List[int] = []
    for i, om in enumerate(omegas):
        got = fragments.peek_data(fragment_key(tp.as_tuple(), om),
                                  touch=True)
        if got is not None:
            results[i] = got
            fragments.note_skip()
            launches.append(LaunchRecord(cand_streamed=0, pat_slots=0,
                                         groups=1, skipped=True))
        else:
            live.append(i)
    return results, live


def record_fragments(
    fragments: Optional[FragmentStore], tp: TriplePattern,
    omegas: Sequence[Optional[np.ndarray]],
    results: Sequence[Tuple[np.ndarray, int]],
) -> None:
    """Register freshly computed selections so the *next* identical
    request -- through any layer -- skips its launch."""
    if fragments is None:
        return
    for om, payload in zip(omegas, results, strict=True):
        fragments.put_data(fragment_key(tp.as_tuple(), om), payload)


def consult_segment(
    fragments: Optional[FragmentStore], seg: FusedSegment,
    results_row: List[Optional[Tuple[np.ndarray, int]]],
    launches: List[LaunchRecord],
) -> List[int]:
    """Fragment-store residency for one fused segment's groups.

    Data segments reuse ``consult_fragments``; count-only groups are
    answered from a resident *data* fragment's cnt (never the other way
    round: a count result carries no rows to reuse). Shared by the
    single-host and sharded fused paths.
    """
    if not seg.count_only:
        res, live = consult_fragments(fragments, seg.tp, seg.omegas,
                                      launches)
        for i, r in enumerate(res):
            if r is not None:
                results_row[i] = r
        return live
    live: List[int] = []
    for i, om in enumerate(seg.omegas):
        got = None
        if fragments is not None:
            got = fragments.peek_data(
                fragment_key(seg.tp.as_tuple(), om), touch=True)
        if got is not None:
            fragments.note_skip()
            launches.append(LaunchRecord(
                cand_streamed=0, pat_slots=0, groups=1, skipped=True))
            results_row[i] = (_EMPTY, int(got[1]))
        else:
            live.append(i)
    return live


def finish_segment(
    fragments: Optional[FragmentStore], seg: FusedSegment,
    omegas_live: Sequence[Optional[np.ndarray]],
    fresh: Sequence[Tuple[np.ndarray, int]],
    results_row: List[Optional[Tuple[np.ndarray, int]]],
    live: Sequence[int],
) -> None:
    """Register fresh results (data segments only) and fill slots."""
    if not seg.count_only:
        record_fragments(fragments, seg.tp, omegas_live, fresh)
    for i, res in zip(live, fresh, strict=True):
        results_row[i] = res


def select_block_numpy(
    block: np.ndarray, tp: TriplePattern,
    patterns: Sequence[List[TriplePattern]],
    layout: KeyLayout, count_only: bool = False,
) -> List[Tuple[np.ndarray, int]]:
    """Numpy evaluation of G grouped selections over one candidate block.

    The small-work fast path: computes exactly what the grouped kernel +
    epilogue compute -- per-row first-matching-pattern index, per-row
    matching-pattern count, the base pattern's residual repeated-
    variable/bound-component mask, then the shared ``stream_order``
    epilogue -- so it is byte-identical to both the kernel path and the
    numpy oracle by the same argument, without launching anything and
    without touching the store's memo layers (``block`` is already in
    hand). ``block`` must cover every instantiated pattern's matches and
    contain no duplicate triples (the candidate-range / sub-range-union
    contracts). ``count_only`` skips the kept-row gather and
    ``stream_order`` entirely: only the Definition-2 ``cnt`` is
    produced (count probes never read the rows).
    """
    comps = tp.as_tuple()
    base = np.ones(block.shape[0], dtype=bool)
    for i, c in enumerate(comps):
        if not is_var(c):
            base &= block[:, i] == c
    for i in range(3):
        for j in range(i + 1, 3):
            if is_var(comps[i]) and comps[i] == comps[j]:
                base &= block[:, i] == block[:, j]
    out: List[Tuple[np.ndarray, int]] = []
    empty = np.empty((0, 3), dtype=np.int32)
    for insts in patterns:
        pats = np.asarray([[c if not is_var(c) else -1
                            for c in p.as_tuple()] for p in insts],
                          dtype=np.int32)                    # [M, 3]
        comp = np.ones((block.shape[0], pats.shape[0]), dtype=bool)
        for i in range(3):
            comp &= (pats[None, :, i] < 0) | (
                block[:, i, None] == pats[None, :, i])       # [T, M]
        comp &= base[:, None]
        keep = comp.any(axis=1)
        cnt = int(comp.sum())
        if count_only or not keep.any():
            out.append((empty, cnt))
            continue
        kept = block[keep]
        first = np.argmax(comp[keep], axis=1)    # first matching pattern
        out.append((stream_order(kept, first, list(insts), layout), cnt))
    return out


class KernelSelector:
    """Bind-join-kernel selector over one :class:`TripleStore`.

    ``fragments`` optionally connects the selector to the unified
    fragment store: selections already resident there are returned
    without a kernel launch (recorded as skipped launches), and fresh
    selections are registered for every other layer to reuse.

    Omega-restricted pruning (docs/pruning.md) is always on: when every
    instantiated pattern binds a prefix of some index order, the launch
    streams the gathered union of their ``(lo, hi)`` sub-ranges
    (:meth:`TripleStore.subranges`) instead of the pattern's full prefix
    range -- byte-identical output, candidate stream shrunk to the
    join-relevant rows. ``fast_path_rows`` > 0 additionally routes
    selections whose (post-pruning) candidate count falls below the
    threshold to the numpy oracle (no launch; recorded in
    :class:`LaunchRecord`).

    ``device`` is where the kernels run: ``None`` means CUDA, and the
    constructor raises when no CUDA device is present. ``"cpu"`` runs
    the kernels' plain PyTorch versions (the CPU tests).
    """

    def __init__(self, store: TripleStore,
                 fragments: Optional[FragmentStore] = None,
                 fast_path_rows: int = 0,
                 device: Optional[str] = None) -> None:
        self.store = store
        self.fragments = fragments
        self.fast_path_rows = int(fast_path_rows)
        self.device = kops.resolve_device(device)
        self.launches: List[LaunchRecord] = []
        # what the CUDA kernels did: one launch per grouped or fused
        # LaunchRecord here, and the live slots of each
        self.cuda = CudaWork()

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """Host -> device copy of one launch input (the store is still
        host-resident; moving it to the device removes this copy)."""
        return torch.as_tensor(x).to(self.device)

    # -- public API ----------------------------------------------------------

    def select_with_cnt(
        self, tp: TriplePattern, omega: Optional[np.ndarray],
        insts: Optional[List[TriplePattern]] = None,
    ) -> Tuple[np.ndarray, int]:
        """Kernel-backed ``brtpf_select_with_cnt`` (byte-identical)."""
        return self.select_same_pattern(
            tp, [omega], None if insts is None else [insts])[0]

    def select_same_pattern(
        self, tp: TriplePattern, omegas: Sequence[Optional[np.ndarray]],
        patterns: Optional[List[List[TriplePattern]]] = None,
    ) -> List[Tuple[np.ndarray, int]]:
        """Serve G same-pattern requests from ONE grouped kernel launch.

        ``omegas`` is one entry per request (None = plain TPF selector);
        ``patterns`` optionally carries the already-instantiated pattern
        lists (the server computes them for lookup accounting -- don't
        redo steps 1-3 of the algorithm here).
        Returns per-request (data-triple sequence, cnt), each identical
        to what ``brtpf_select_with_cnt(store, tp, omega_g)`` returns.

        Groups whose selection is already resident in the connected
        fragment store never reach the kernel: their launch share is
        recorded as skipped and only the remaining groups launch.
        """
        _trace.phase("prep")
        if patterns is None:
            patterns = [instantiate_patterns(tp, om) for om in omegas]
        results, live = consult_fragments(self.fragments, tp, omegas,
                                          self.launches)
        if live:
            live_omegas = [omegas[i] for i in live]
            fresh = self._launch_groups(tp, live_omegas,
                                        [patterns[i] for i in live])
            _trace.phase("serve")
            record_fragments(self.fragments, tp, live_omegas, fresh)
            for i, res in zip(live, fresh, strict=True):
                results[i] = res
        return results

    def select_count(self, tp: TriplePattern, omega: Optional[np.ndarray],
                     insts: Optional[List[TriplePattern]] = None) -> int:
        """Count-only selection: Definition-2 ``cnt``, no row gather.

        The standalone count-probe path (docs/fusion.md): the candidate
        stream and the bind-join grid are still evaluated (the count
        needs them) but no kept row is ever compacted, gathered, or
        stream-ordered. A resident data fragment answers for free.
        """
        if self.fragments is not None:
            got = self.fragments.peek_data(
                fragment_key(tp.as_tuple(), omega), touch=True)
            if got is not None:
                self.fragments.note_skip()
                self.launches.append(LaunchRecord(
                    cand_streamed=0, pat_slots=0, groups=1, skipped=True))
                return int(got[1])
        patterns = [insts if insts is not None
                    else instantiate_patterns(tp, omega)]
        return self._launch_groups(tp, [omega], patterns,
                                   count_only=True)[0][1]

    def select_fused(self, segments: Sequence[FusedSegment]
                     ) -> List[List[Tuple[np.ndarray, int]]]:
        """Serve S heterogeneous segments from ONE fused kernel launch.

        Each segment is exactly what ``select_same_pattern`` serves
        alone: one triple pattern plus its request groups. The fused
        path lays every segment's (pruned) candidate block end to end,
        marshals rectangular per-segment slot tables, and launches the
        fused kernel (``kops.bindjoin_fused_cuda``) once, with one page
        per segment over its own rows, matched against its own slot
        table and base pattern. One compaction and one device-to-host
        copy follow, split per (segment, group) on the host. Residency
        skips, Omega-restricted pruning, the small-work fast path, and
        the ``stream_order`` parity epilogue all behave exactly as on
        the unfused path, so fragments are byte-identical. When
        ``fusion_legality`` refuses (declared dependencies or capacity
        ceilings) or only one segment has launch-worthy work, every
        segment falls back to its own grouped launch.
        """
        results: List[List[Optional[Tuple[np.ndarray, int]]]] = [
            [None] * len(seg.omegas) for seg in segments]
        prepared: List[Tuple[int, List[List[TriplePattern]], List[int]]] = []
        for si, seg in enumerate(segments):
            patterns = seg.patterns
            if patterns is None:
                patterns = [instantiate_patterns(seg.tp, om)
                            for om in seg.omegas]
            live = self._consult_segment(seg, results[si])
            if live:
                prepared.append((si, patterns, live))

        # Per-segment prologue, identical to ``_launch_groups``: range,
        # sub-range union, small-work fast path. Only segments that
        # would genuinely launch join the fused stream.
        work = []
        for si, patterns, live in prepared:
            _trace.phase("prep")
            seg = segments[si]
            omegas_live = [seg.omegas[i] for i in live]
            pats_live = [patterns[i] for i in live]
            rng = self.store.candidate_range(seg.tp)
            full = len(rng)
            if full == 0:
                for i in live:
                    results[si][i] = (_EMPTY, 0)
                continue
            all_insts = [p for group in pats_live for p in group]
            sr = self.store.subranges(seg.tp, insts=all_insts)
            pruned = sr is not None and sr.rows < full
            block = None
            if pruned:
                block = self.store.gather_subranges(sr)
                t = int(block.shape[0])
                if t == 0:
                    for i in live:
                        results[si][i] = (_EMPTY, 0)
                    continue
            else:
                t = full
            if 0 < t <= self.fast_path_rows:
                self.launches.append(LaunchRecord(
                    cand_streamed=t, pat_slots=0, groups=len(live),
                    pruned=pruned, cand_full=full, fast_path=True))
                if block is None:
                    block = rng.triples
                fresh = select_block_numpy(block, seg.tp, pats_live,
                                           self.store.layout,
                                           count_only=seg.count_only)
                _trace.phase("serve")
                self._finish_segment(seg, omegas_live, fresh,
                                     results[si], live)
                continue
            if block is None:
                block = rng.triples
            work.append((si, pats_live, omegas_live, live, block, t,
                         pruned, full))

        if not work:
            return results

        _trace.phase("prep")
        # Fused geometry, the JAX package's (legality and LaunchRecord):
        # common padded (G, Mp) slot grid, power-of-two segment/tile
        # counts, each segment's block aligned to bt-row tiles.
        bt = FUSED_BT
        s = len(work)
        s_pad = _pow2_at_least(s)
        g_pad = _pow2_at_least(max(len(w[3]) for w in work))
        m_max = max(max(len(p) for p in w[1]) for w in work)
        mp = kops.padded_pattern_slots(m_max)
        tiles = [-(-w[5] // bt) for w in work]
        total_tiles = sum(tiles)
        reason = fusion_legality(
            [segments[w[0]] for w in work],
            stream_rows=total_tiles * bt, slot_table=s_pad * g_pad * mp)
        if s == 1 or reason is not None:
            # Documented fallback (docs/fusion.md): one grouped launch
            # per segment, same blocks, byte-identical results.
            for si, pats_live, omegas_live, live, block, t, pruned, full \
                    in work:
                seg = segments[si]
                fresh = self._launch_block(
                    seg.tp, pats_live, block, t, pruned, full,
                    count_only=seg.count_only)
                _trace.phase("serve")
                self._finish_segment(seg, omegas_live, fresh,
                                     results[si], live)
            return results

        # One fused launch: the segments' blocks laid end to end as a
        # one-shard store, one page per segment spanning its own rows,
        # each page against its segment's slot table and base vector.
        cand = np.concatenate([w[4] for w in work]).astype(np.int32,
                                                          copy=False)
        ends = np.cumsum([w[5] for w in work])
        spans = np.stack([ends - [w[5] for w in work], ends], axis=-1)
        grids = [marshal_pattern_grid(segments[w[0]].tp, w[1], g_pad, m_max)
                 for w in work]
        slots, live = kops.pack_slots(
            np.concatenate([pg for pg, _v, _b in grids]),
            np.concatenate([v for _p, v, _b in grids]), mp)
        _trace.phase("copy_in")
        seg_of_page = self._to_device(np.arange(s, dtype=np.int32))
        spans_d = self._to_device(spans[:, None].astype(np.int64))
        mask, first, cnt, _ = kops.bindjoin_fused_cuda(
            self._to_device(np.ascontiguousarray(cand))[None], None,
            self._to_device(slots.reshape(s, g_pad, mp, 4)),
            self._to_device(np.stack([b for _p, _v, b in grids])),
            spans=spans_d, seg_of_page=seg_of_page,
            width=int(max(w[5] for w in work)), live=live)

        _trace.phase("collect")
        full_tiles = sum(-(-w[7] // bt) for w in work)
        self.cuda.launches += 1
        self.cuda.live_slots += max(live_slot_count(v) for _p, v, _b in grids)
        self.launches.append(LaunchRecord(
            cand_streamed=_pow2_at_least(total_tiles) * bt,
            pat_slots=g_pad * mp,
            groups=sum(len(w[3]) for w in work),
            pruned=any(w[6] for w in work),
            cand_full=_pow2_at_least(full_tiles) * bt,
            segments=s, cand_rows=sum(w[5] for w in work),
            full_rows=sum(w[7] for w in work)))

        gathered = [not segments[w[0]].count_only for w in work]
        if any(gathered) and not all(gathered):
            # count-only segments return only cnt: their pages keep no cell
            mask *= self._to_device(np.array(gathered, np.uint8))[
                :, None, None, None]
        # the payload is a kept row's position in the concatenated blocks
        cnts, kept = grouped_results(
            mask, first, cnt, g_pad, not any(gathered),
            payload=lambda c: c[:, 3:4] + spans_d[c[:, 0], 0, :1],
            seg_of_page=seg_of_page, segments=s)
        self.cuda.rows_back += rows_back(kept)
        for wi, (si, pats_live, omegas_live, live_g, _b, _t, _pr, _full) \
                in enumerate(work):
            _trace.phase("order")
            seg = segments[si]
            fresh: List[Tuple[np.ndarray, int]] = []
            for gi in range(len(live_g)):
                cnt_g = int(cnts[wi, gi])
                if seg.count_only or kept[wi][gi][1].shape[0] == 0:
                    fresh.append((_EMPTY, cnt_g))
                    continue
                pos, first_g = kept[wi][gi]
                fresh.append((stream_order(cand[pos[:, 0]], first_g,
                                           pats_live[gi], self.store.layout),
                               cnt_g))
            _trace.phase("serve")
            self._finish_segment(seg, omegas_live, fresh, results[si],
                                 live_g)
        return results

    def _consult_segment(self, seg: FusedSegment,
                         results_row: List[Optional[Tuple[np.ndarray, int]]]
                         ) -> List[int]:
        return consult_segment(self.fragments, seg, results_row,
                               self.launches)

    def _finish_segment(self, seg: FusedSegment,
                        omegas_live: Sequence[Optional[np.ndarray]],
                        fresh: Sequence[Tuple[np.ndarray, int]],
                        results_row: List[Optional[Tuple[np.ndarray, int]]],
                        live: Sequence[int]) -> None:
        return finish_segment(self.fragments, seg, omegas_live, fresh,
                              results_row, live)

    def _launch_groups(
        self, tp: TriplePattern, omegas: Sequence[Optional[np.ndarray]],
        patterns: List[List[TriplePattern]], count_only: bool = False,
    ) -> List[Tuple[np.ndarray, int]]:
        """One grouped kernel launch over the store-miss groups."""
        rng = self.store.candidate_range(tp)
        full = len(rng)
        if full == 0:
            return [(_EMPTY, 0)] * len(omegas)

        g = len(omegas)

        # Omega-restricted pruning: the union of the groups' per-binding
        # sub-ranges covers every triple that can match any instantiated
        # pattern, so streaming only that union is exact. The flat
        # (cross-group) instantiation list keeps the grouped geometry:
        # one candidate block still serves all G requests.
        all_insts = [p for group in patterns for p in group]
        sr = self.store.subranges(tp, insts=all_insts)
        pruned = sr is not None and sr.rows < full
        if pruned:
            block = self.store.gather_subranges(sr)
            t = int(block.shape[0])
            if t == 0:
                # no binding has any candidates (e.g. Omega values
                # absent from the store): nothing to stream, cnt = 0
                return [(_EMPTY, 0)] * len(omegas)
        else:
            t = full

        # Small-work fast path: below the threshold the kernel cannot
        # pay its dispatch overhead -- serve the groups from the numpy
        # oracle and record the decision (no kernel launch charged).
        if 0 < t <= self.fast_path_rows:
            self.launches.append(LaunchRecord(
                cand_streamed=t, pat_slots=0, groups=g,
                pruned=pruned, cand_full=full, fast_path=True))
            if not pruned:
                block = rng.triples
            return select_block_numpy(block, tp, patterns, self.store.layout,
                                      count_only=count_only)

        if not pruned:
            block = rng.triples
        return self._launch_block(tp, patterns, block, t, pruned, full,
                                  count_only=count_only)

    def _launch_block(
        self, tp: TriplePattern, patterns: List[List[TriplePattern]],
        block: np.ndarray, t: int, pruned: bool, full: int,
        count_only: bool = False,
    ) -> List[Tuple[np.ndarray, int]]:
        """The grouped launch proper, over an already-prepared block.

        Shared by ``_launch_groups`` and ``select_fused``'s legality
        fallback so both take the exact same launch with the exact same
        accounting. ``count_only`` skips the compact/gather/stream
        epilogue: only the per-group Definition-2 counts come back.
        """
        _trace.phase("prep")
        g = len(patterns)
        m = max(len(p) for p in patterns)
        pats, valid, base_vec = marshal_pattern_grid(tp, patterns, g, m)
        mp = kops.padded_pattern_slots(m)
        slots, live = kops.pack_slots(pats, valid, mp)

        # One page, one shard: the block's own rows over [0, t), in a
        # launch as wide as the block's shape bucket.
        tpad = _bucket(t)
        _trace.phase("copy_in")
        mask, first, cnt, _ = kops.bindjoin_grouped_cuda(
            self._to_device(np.ascontiguousarray(block, np.int32))[None],
            None, self._to_device(slots), self._to_device(base_vec),
            live=live, width=tpad,
            spans=self._to_device(np.array([[[0, t]]], np.int64)))
        _trace.phase("collect")
        self.cuda.launches += 1
        self.cuda.live_slots += live_slot_count(valid)
        self.launches.append(
            LaunchRecord(cand_streamed=tpad, pat_slots=g * mp, groups=g,
                         pruned=pruned, cand_full=_bucket(full),
                         cand_rows=t, full_rows=full))
        cnts, kept = grouped_results(mask, first, cnt, g, count_only,
                                     payload=lambda c: c[:, 3:4])
        self.cuda.rows_back += rows_back(kept)
        cnts, kept = cnts[0], kept[0] if kept else None
        _trace.phase("order")
        out: List[Tuple[np.ndarray, int]] = []
        for gi in range(g):
            if count_only or kept[gi][1].shape[0] == 0:
                out.append((_EMPTY, int(cnts[gi])))
                continue
            rows, first_g = kept[gi]
            out.append((self._stream_order(block[rows[:, 0]], first_g,
                                           patterns[gi]), int(cnts[gi])))
        return out

    # -- ordering epilogue ---------------------------------------------------

    def _stream_order(self, kept: np.ndarray, first: np.ndarray,
                      insts: List[TriplePattern]) -> np.ndarray:
        return stream_order(kept, first, insts, self.store.layout)
