"""Distributed brTPF: the triple store split into logical shards.

The port of ``repro.core.federation``. The paper (section 2.2) notes
that TPF-style interfaces compose into federations of servers. The JAX
package lays the federation over a device mesh, one shard per device.
Here every shard lives on ONE CUDA device: the mesh axis becomes a
leading *logical shard axis* of every store tensor (``[shards, shard_n,
...]``) and the all-gather back to the client is the identity on that
axis. A grouped request makes one bind-join launch per chunk of its
window pages, over every shard at once (:meth:`FederatedStore.grouped_step`:
the kernel reads the shards' rows where they lie and runs the base
pattern's match in its prologue). A heterogeneous batch makes one fused
bind-join launch per chunk of an order group's (round, segment) pages
(:meth:`FederatedStore.fused_step`: the same kernel, each page against
its own segment's slots and base pattern). The full-shard step makes
one launch per kernel over all shards' rows laid end to end and returns
the reference's post-all-gather shapes. Multiple GPUs are not used.

A request -- (triple pattern, attached mappings) -- is evaluated by
every shard on its own partition: each shard binary-searches its sorted
keys for the pattern's bound-prefix range and streams only a fixed
``window`` of it per launch, so per-request device work scales with the
window, never with the range or the shard size.
:class:`ShardedSelector` packages this as a selector backend for
:class:`~repro_torch.core.server.BrTPFServer` (``selector_backend=
"sharded"``), byte-identical to ``selectors.brtpf_select_with_cnt`` and
sharing the grouped multi-request geometry and the
:class:`~repro_torch.core.kernel_selectors.LaunchRecord` accounting with
the single-host kernel path. The host planner (``plan_windows``) and the
ordering epilogue (``stream_order``) stay numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from . import trace as _trace
from .fragments import FragmentStore, fragment_key
from .kernel_selectors import (_EMPTY, FusedSegment, LaunchRecord,
                               consult_fragments, consult_segment,
                               finish_segment, fusion_legality,
                               grouped_results, live_slot_count,
                               marshal_pattern_grid, record_fragments,
                               select_block_numpy, stream_order)
from .metrics import CudaWork
from .placement import HeatLog, Placement
from .rdf import TriplePattern, is_var
from .selectors import instantiate_patterns
from .store import _ORDERS, _pack

# Default per-shard window: one launch streams this many candidate rows
# per shard. The reference sized it as 8 x 128 TPU VPU sublane x lane
# tiles; that rationale is a TPU one. The port keeps the value only so
# that the launch geometry (pages, LaunchRecords, budgets) equals the
# reference's.
DEFAULT_SHARD_WINDOW = 1024

# Rows (pages x shards x window) that one grouped launch covers: the
# kernel backend's largest candidate block (the 4,194,304-row bucket of
# a frequent predicate's range), the shape chip_smoke.py times the
# grouped kernel at. It bounds a chunk's outputs to 5 bytes per row and
# group (the uint8 mask and the int32 first-match index).
MAX_CHUNK_ROWS = 1 << 22

_PAD_KEY = np.iinfo(np.int64).max


def _to(x, device, dtype=None) -> torch.Tensor:
    """Host value (numpy, int or tensor) -> tensor on ``device``."""
    return torch.as_tensor(x, dtype=dtype).to(device)


def _search(keys: torch.Tensor, lo: int, hi: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard [start, end) of the inclusive key range [lo, hi]: one
    batched ``searchsorted`` over ``keys[shards, shard_n]``."""
    s = keys.shape[0]
    lo_t = torch.full((s, 1), int(lo), dtype=torch.int64, device=keys.device)
    hi_t = torch.full((s, 1), int(hi), dtype=torch.int64, device=keys.device)
    start = torch.searchsorted(keys, lo_t, side="left")[:, 0]
    end = torch.searchsorted(keys, hi_t, side="right")[:, 0]
    return start, end


def _shard_rows(cand: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Gather rows ``pos[s, ...]`` of each shard ``s`` of ``cand[s, n, ...]``
    (the per-shard ``dynamic_slice`` / ``take`` of the reference)."""
    sidx = torch.arange(cand.shape[0], device=cand.device)
    return cand[sidx.reshape(-1, *([1] * (pos.dim() - 1))), pos]


def _local_brtpf(cand: torch.Tensor, patterns: torch.Tensor,
                 pat_valid: torch.Tensor, base_vec: torch.Tensor,
                 cand_valid: torch.Tensor, capacity: int):
    """Per-shard selector: Definition 1 on every local partition.

    ``cand`` is int32 [shards, n, 3] with ``cand_valid`` bool [shards, n];
    all shards go through the ungrouped bind-join and the match kernel
    in one launch each. ``base_vec`` carries the original pattern's
    repeated-variable equality flags (the instantiated-pattern grid
    alone cannot express them). Returns fixed-shape local pages
    (shards, capacity, 3) padded with -1, and the per-shard counts.
    """
    s, n = cand_valid.shape
    flat = cand.reshape(s * n, 3)
    keep, _ = kops.bindjoin(flat, patterns, pat_valid)
    keep = keep & kops.tpf_match(flat, base_vec) & cand_valid.reshape(-1)
    idx, count = kops.compact_mask(keep.reshape(s, n), capacity)
    page = _shard_rows(cand, idx.clamp(min=0).long())
    page = torch.where((idx >= 0)[..., None], page, -1)
    return page, count


@dataclasses.dataclass
class ShardIndex:
    """One component order's per-shard sorted mirror of the partition.

    ``host_keys`` keeps a host-side copy of the per-shard sorted keys:
    the request planner (:meth:`FederatedStore.plan_windows`) uses it to
    binary-search shard-local ranges and Omega sub-ranges *before*
    launching, so windows provably disjoint from every sub-range are
    never dispatched. (The device step re-derives the same bounds with
    an on-device searchsorted -- the host copy only steers which pages
    launch, it never feeds result data.)
    """

    name: str                # "spo" | "pos" | "osp"
    triples: torch.Tensor    # int32 [shards, shard_n, 3], per-shard sorted
    valid: torch.Tensor      # bool  [shards, shard_n]
    keys: torch.Tensor       # int64 [shards, shard_n]
    host_keys: np.ndarray    # int64 [shards, shard_n] (same values)

    @classmethod
    def on_device(cls, name: str, triples: np.ndarray, valid: np.ndarray,
                  keys: np.ndarray, device) -> "ShardIndex":
        return cls(name=name, triples=_to(triples, device),
                   valid=_to(valid, device), keys=_to(keys, device),
                   host_keys=keys)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.triples, self.valid, self.keys))


@dataclasses.dataclass
class WindowPlan:
    """Host-side launch plan for one (grouped) windowed request.

    ``pages`` lists the window indexes that can contain join-relevant
    rows on at least one shard; everything else is skipped. Unpruned
    plans list every page of the pattern's bound-prefix range under
    ``order``; pruned plans keep only pages intersecting some
    per-binding sub-range. ``candidate_rows`` is the total (cross-shard)
    row count inside the relevant sub-ranges -- the small-work fast
    path's decision quantity.
    """

    order: str
    lo_key: int
    hi_key: int
    pages: List[int]
    range_rows: int          # sum over shards of the base range length
    candidate_rows: int      # rows inside relevant sub-ranges (<= above)
    pruned: bool
    pages_total: int         # pages an unpruned plan would launch
    # Per shard the base range bounds [start, end) -- absolute
    # shard-local positions. Set on every plan (per-shard attribution
    # and replica routing need it); ``shard_spans`` additionally carries
    # the merged live sub-range spans that sub-window compaction needs,
    # and stays None when unpruned.
    shard_bounds: Optional[List[Tuple[int, int]]] = None
    shard_spans: Optional[List[np.ndarray]] = None


@dataclasses.dataclass
class FederatedStore:
    """Triple store split into ``shards`` logical shards on one device
    (one shard = one federation member, the reference's one device).

    Each shard keeps its partition sorted with packed int64 keys in all
    three component orders -- SPO plus the POS/OSP mirrors (every
    federation member is an HDT-style server with HDT's three indexes).
    The mirrors are what let unbound-subject patterns (``(?s, p, ?o)``,
    ``(?s, ?p, o)``) binary-search a narrow shard-local range instead of
    scanning the whole shard, and the *windowed* request path streams
    only a fixed window of the chosen order's range per launch. Every
    order's triples, valid flags and keys live on ``device``.
    """

    shards: int
    device: torch.device
    triples: Optional[torch.Tensor]   # SPO mirror (alias of indexes["spo"])
    valid: Optional[torch.Tensor]
    keys: Optional[torch.Tensor]
    shard_n: int
    indexes: Dict[str, ShardIndex] = dataclasses.field(
        default_factory=dict, repr=False)
    # cache of the windowed request steps, keyed on the static launch
    # geometry (window, groups, pattern slots, projection) as in the
    # reference's jit cache.
    _steps: Dict[tuple, object] = dataclasses.field(
        default_factory=dict, repr=False)
    # Workload-aware placement (docs/federation.md, "Placement"): when
    # set, shard boundaries follow the heat-weighted quantiles instead
    # of the equal split, and ``placement.replicas`` ranges are held by
    # several shards (the routed launch path dedups them to one owner).
    placement: Optional[Placement] = None
    # Host copy of the unsharded dataset, kept so ``repartition`` can
    # rebuild under new boundaries without a device gather.
    host_triples: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)

    @property
    def nbytes(self) -> int:
        """Device bytes held by the three orders' tensors."""
        return sum(ix.nbytes for ix in self.indexes.values())

    @classmethod
    def _assemble(cls, triples_np, shards, device, shard_n, indexes,
                  placement=None) -> "FederatedStore":
        spo = indexes["spo"]
        return cls(shards=shards, device=device, triples=spo.triples,
                   valid=spo.valid, keys=spo.keys, shard_n=shard_n,
                   indexes=indexes, placement=placement,
                   host_triples=np.asarray(triples_np))

    @classmethod
    def build(cls, triples_np: np.ndarray, shards: int = 1,
              device=None,
              placement: Optional[Placement] = None) -> "FederatedStore":
        """Split ``triples_np`` into ``shards`` logical shards on
        ``device`` (``None`` means CUDA, and raises without it)."""
        device = kops.resolve_device(device)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if placement is not None:
            return cls._build_placed(triples_np, shards, device, placement)
        n = triples_np.shape[0]
        shard_n = max(1, -(-n // shards))
        total = shard_n * shards
        base = np.full((total, 3), -1, dtype=np.int32)
        base[:n] = triples_np
        base_valid = np.zeros((total,), dtype=bool)
        base_valid[:n] = True
        rows = np.arange(shards)[:, None]
        indexes: Dict[str, ShardIndex] = {}
        for name, comp_order in _ORDERS.items():
            # per-shard stable sort under this order's packed key
            # (padding rows key to +inf -> sort last)
            keys = np.where(
                base_valid,
                _pack(base[:, comp_order[0]], base[:, comp_order[1]],
                      base[:, comp_order[2]]),
                _PAD_KEY).reshape(shards, shard_n)
            order = np.argsort(keys, axis=1, kind="stable")
            indexes[name] = ShardIndex.on_device(
                name, base.reshape(shards, shard_n, 3)[rows, order],
                base_valid.reshape(shards, shard_n)[rows, order],
                np.take_along_axis(keys, order, axis=1), device)
        return cls._assemble(triples_np, shards, device, shard_n, indexes)

    @classmethod
    def _build_placed(cls, triples_np: np.ndarray, shards: int, device,
                      placement: Placement) -> "FederatedStore":
        """Build under workload-aware boundaries + replicated ranges.

        Per order, each triple's packed key is assigned to the shard
        whose boundary span owns it (``Placement.shard_of``; orders
        without boundaries fall back to an equal-count contiguous
        split), then every :class:`~repro_torch.core.placement.ReplicaRange`'s
        rows are *additionally* copied onto its replica shards.  Each
        shard's partition stays a contiguous key range plus whole
        replicated sub-ranges, sorted -- which is what lets the routed
        launch path subtract a replica range from non-owners by a pair
        of binary searches.
        """
        per_order_rows: Dict[str, List[np.ndarray]] = {}
        for name, comp_order in _ORDERS.items():
            keys = _pack(triples_np[:, comp_order[0]],
                         triples_np[:, comp_order[1]],
                         triples_np[:, comp_order[2]])
            bounds = placement.boundaries.get(name)
            if bounds is not None and len(bounds) == shards - 1:
                assign = np.searchsorted(
                    np.asarray(bounds, dtype=np.int64), keys, side="right")
            else:
                # equal-count contiguous fallback over this order's
                # sorted keys (still a contiguous key partition)
                order = np.argsort(keys, kind="stable")
                assign = np.empty(keys.shape, dtype=np.int64)
                cutpos = np.arange(1, shards) * keys.size // shards
                assign[order] = np.searchsorted(
                    cutpos, np.arange(keys.size), side="right")
            rows = [triples_np[assign == s] for s in range(shards)]
            for rr in placement.replicas.get(name, ()):
                sel = (keys >= rr.lo_key) & (keys <= rr.hi_key)
                block = triples_np[sel]
                if block.shape[0] == 0:
                    continue
                for rs in rr.replicas:
                    if rs != rr.home:
                        rows[rs] = np.concatenate([rows[rs], block],
                                                  axis=0)
            per_order_rows[name] = rows
        shard_n = max(1, max(r.shape[0] for rows in per_order_rows.values()
                             for r in rows))
        indexes: Dict[str, ShardIndex] = {}
        for name, comp_order in _ORDERS.items():
            padded = np.full((shards, shard_n, 3), -1, dtype=np.int32)
            valid = np.zeros((shards, shard_n), dtype=bool)
            keys = np.full((shards, shard_n), _PAD_KEY, dtype=np.int64)
            for s, block in enumerate(per_order_rows[name]):
                m = block.shape[0]
                k = _pack(block[:, comp_order[0]], block[:, comp_order[1]],
                          block[:, comp_order[2]])
                order = np.argsort(k, kind="stable")
                padded[s, :m] = block[order]
                valid[s, :m] = True
                keys[s, :m] = k[order]
            indexes[name] = ShardIndex.on_device(name, padded, valid, keys,
                                                 device)
        return cls._assemble(triples_np, shards, device, shard_n, indexes,
                             placement=placement)

    def repartition(self, heat: HeatLog, **plan_kwargs) -> "FederatedStore":
        """Rebuild with workload-aware boundaries planned from ``heat``.

        Returns a NEW store (rebuild-with-cutover: the caller swaps it in
        atomically and must invalidate any :class:`FragmentStore` pages
        planned against the old partitioning).
        """
        from .placement import dataset_keys, plan_placement
        if self.host_triples is None:
            raise ValueError(
                "host triples unavailable; the store was not built via "
                "FederatedStore.build")
        placement = plan_placement(
            heat, dataset_keys(self.host_triples), self.shards,
            **plan_kwargs)
        return FederatedStore.build(self.host_triples, self.shards,
                                    device=self.device, placement=placement)

    # -- host-side request marshalling ---------------------------------------

    def request_arrays(self, tp: TriplePattern,
                       omega: Optional[np.ndarray],
                       max_mpr: int) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
        """Host-side request marshalling: instantiate + dedup (server
        algorithm steps 1-3) and pad to the interface's maxMpR."""
        insts = instantiate_patterns(tp, omega)
        if len(insts) > max_mpr:
            raise ValueError(f"{len(insts)} instantiations > maxMpR")
        pats = np.full((max_mpr, 3), -1, dtype=np.int32)
        valid = np.zeros((max_mpr,), dtype=np.int32)
        for i, p in enumerate(insts):
            pats[i] = [c if not is_var(c) else -1 for c in p.as_tuple()]
            valid[i] = 1
        comps = tp.as_tuple()
        base_vec = kops.pattern_vec_from(
            tuple(-1 if is_var(c) else c for c in comps),
            eq_sp=int(is_var(comps[0]) and comps[0] == comps[1]),
            eq_so=int(is_var(comps[0]) and comps[0] == comps[2]),
            eq_po=int(is_var(comps[1]) and comps[1] == comps[2]),
        )
        return pats, valid, base_vec

    @staticmethod
    def prefix_keys(tp: TriplePattern,
                    order_name: str = "spo") -> Tuple[int, int]:
        """(lo_key, hi_key) of the pattern's bound prefix under the
        given index order -- the host-computed range bounds every shard
        binary-searches (the client computing a page URL, in federation
        terms). Defaults to the SPO mirror for compatibility with the
        single-request windowed path."""
        from .store import _MAX_ID, _ORDERS, _pack
        comp_order = _ORDERS[order_name]
        comps = tp.as_tuple()
        prefix = []
        for pos in comp_order:
            if is_var(comps[pos]):
                break
            prefix.append(comps[pos])
        lo_vals = prefix + [0] * (3 - len(prefix))
        hi_vals = prefix + [_MAX_ID] * (3 - len(prefix))
        lo = int(_pack(np.int64(lo_vals[0]), np.int64(lo_vals[1]),
                       np.int64(lo_vals[2])))
        hi = int(_pack(np.int64(hi_vals[0]), np.int64(hi_vals[1]),
                       np.int64(hi_vals[2])))
        return lo, hi

    # -- host-side launch planning (Omega-restricted window skip) ------------

    def plan_windows(self, tp: TriplePattern,
                     insts: Sequence[TriplePattern],
                     window: int) -> WindowPlan:
        """Plan the window launches for one (grouped) request.

        Index choice: when every instantiated pattern shares one shape
        whose best index binds a longer prefix than the base pattern
        does under that index, the launch streams THAT order and the
        per-binding sub-ranges become host-computable window filters;
        otherwise the base pattern's own best index is used (the
        POS/OSP mirrors are what make this a real choice -- an
        unbound-subject pattern no longer scans whole shards).

        Window skip: the per-binding ``(lo, hi)`` key intervals are
        batch-searchsorted against every shard's host key copy; a window
        page whose owned span intersects no sub-range on any shard is
        provably match-free (every triple matching instantiation ``p_j``
        has its key inside ``p_j``'s interval) and is dropped from
        ``pages``. Skipping whole pages never reorders or duplicates
        anything, so parity is untouched.
        """
        from .store import (TripleStore, _ORDERS, merge_spans,
                            prefix_interval_keys)
        window = max(1, min(int(window), self.shard_n))

        def base_plan(order_name: str) -> WindowPlan:
            lo, hi = self.prefix_keys(tp, order_name)
            hk = self.indexes[order_name].host_keys
            starts = np.array([np.searchsorted(hk[s], lo, side="left")
                               for s in range(hk.shape[0])])
            ends = np.array([np.searchsorted(hk[s], hi, side="right")
                             for s in range(hk.shape[0])])
            range_rows = int((ends - starts).sum())
            pages_total = int(max(
                (-(-int(e - s) // window)
                 for s, e in zip(starts, ends, strict=True)), default=0))
            return WindowPlan(order=order_name, lo_key=lo, hi_key=hi,
                              pages=list(range(pages_total)),
                              range_rows=range_rows,
                              candidate_rows=range_rows, pruned=False,
                              pages_total=pages_total,
                              shard_bounds=[
                                  (int(s), int(e)) for s, e in
                                  zip(starts, ends, strict=True)])

        bname, _ = TripleStore._choose_index(tp)
        unpruned = base_plan(bname)
        shapes = {tuple(is_var(c) for c in p.as_tuple()) for p in insts}
        if len(shapes) != 1 or not insts:
            return unpruned
        iname, iplen = TripleStore._choose_index(insts[0])
        # prefix the BASE pattern binds under the instantiations' best
        # index: pruning pays only if instantiations bind more
        comp_order = _ORDERS[iname]
        base_plen = 0
        for pos in comp_order:
            if is_var(tp.as_tuple()[pos]):
                break
            base_plen += 1
        if iplen <= base_plen:
            return unpruned
        comps = np.asarray([p.as_tuple() for p in insts], dtype=np.int64)
        lo_keys, hi_keys = prefix_interval_keys(comps, comp_order, iplen)
        # base range under the insts' index (already computed when the
        # instantiations' best order is the base pattern's own)
        shell = unpruned if iname == bname else base_plan(iname)
        hk = self.indexes[iname].host_keys
        pages: set = set()
        candidate_rows = 0
        shard_bounds: List[Tuple[int, int]] = []
        shard_spans: List[np.ndarray] = []
        for s in range(hk.shape[0]):
            start = int(np.searchsorted(hk[s], shell.lo_key,
                                        side="left"))
            end = int(np.searchsorted(hk[s], shell.hi_key,
                                      side="right"))
            shard_bounds.append((start, end))
            if end <= start:
                shard_spans.append(np.empty((0, 2), dtype=np.int64))
                continue
            a = np.searchsorted(hk[s], lo_keys, side="left")
            b = np.searchsorted(hk[s], hi_keys, side="right")
            spans = merge_spans(np.stack([a, b], axis=1))
            clipped: List[Tuple[int, int]] = []
            for slo, shi in spans:
                # instantiation intervals are sub-intervals of the base
                # range under the same order, but clip defensively
                slo = max(int(slo), start)
                shi = min(int(shi), end)
                if shi <= slo:
                    continue
                candidate_rows += shi - slo
                clipped.append((slo, shi))
                pages.update(range((slo - start) // window,
                                   (shi - 1 - start) // window + 1))
            shard_spans.append(
                np.asarray(clipped, dtype=np.int64).reshape(-1, 2))
        pruned = WindowPlan(order=iname, lo_key=shell.lo_key,
                            hi_key=shell.hi_key, pages=sorted(pages),
                            range_rows=shell.range_rows,
                            candidate_rows=candidate_rows, pruned=True,
                            pages_total=shell.pages_total,
                            shard_bounds=shard_bounds,
                            shard_spans=shard_spans)
        # the base pattern's own index may beat sub-range skipping under
        # the instantiations' index (fewer actual window dispatches win)
        return pruned if len(pruned.pages) <= len(unpruned.pages) \
            else unpruned

    # -- the request path ----------------------------------------------------

    def execute(self, tp: TriplePattern, omega: Optional[np.ndarray],
                max_mpr: int, capacity: int) -> np.ndarray:
        """Run one distributed brTPF request; returns matching triples.

        Routed through the windowed step (the default request path):
        per-shard device work is bounded by the window, and -- unlike
        :meth:`execute_full` -- the result can never be truncated by an
        undersized ``capacity`` (each window's page capacity is the
        window itself).
        """
        return self.execute_windowed(tp, omega, max_mpr, capacity,
                                     window=min(capacity, self.shard_n))

    def execute_full(self, tp: TriplePattern, omega: Optional[np.ndarray],
                     max_mpr: int, capacity: int) -> np.ndarray:
        """The paper-faithful baseline: every shard streams its whole
        partition through the ungrouped bind-join kernel, all shards in
        one launch. ``capacity`` bounds each shard's local page (matches
        beyond it are silently dropped)."""
        if self.placement is not None and self.placement.has_replicas:
            raise RuntimeError(
                "execute_full cannot serve a replicated placement: the "
                "full-shard stream would report replicated ranges once "
                "per holder -- use the windowed (routed) path")
        pats, valid, base_vec = self.request_arrays(tp, omega, max_mpr)
        dev = self.device
        pages, _counts = self.lowerable(capacity)(
            self.triples, self.valid, _to(pats, dev), _to(valid, dev),
            _to(base_vec, dev))
        pages = pages.reshape(-1, 3).cpu().numpy()
        keep = pages[:, 0] >= 0  # -1-padded rows are invalid
        return pages[keep]

    def lowerable(self, capacity: int):
        """The full-shard-stream request step: ``step(triples, valid,
        pats, pat_valid, base_vec) -> (pages (S, capacity, 3), counts
        (S,))``."""

        def step(triples, valid, pats, pat_valid, base_vec):
            return _local_brtpf(triples, pats, pat_valid, base_vec, valid,
                                capacity)

        return step

    # -- the windowed request path (default) ---------------------------------

    def lowerable_windowed(self, capacity: int, window: int,
                           wild_cols: tuple = (0, 1, 2)):
        """Single-request windowed step:

        1. *windowed scan*: each shard binary-searches its sorted keys
           for the pattern's bound-prefix range and runs the bind-join
           kernel over a fixed ``window`` starting there, not the whole
           shard;
        2. *column projection*: only the pattern's unbound components
           (``wild_cols``) come back -- the bound components are implied
           by the request.

        ``step(triples, valid, keys, pats, pat_valid, base_vec, lo_key,
        hi_key, page_idx)`` with int ``lo_key``/``hi_key`` (host-computed
        from the pattern prefix) and int ``page_idx``; returns pages
        (S, capacity, C), counts (S,) and range lengths (S,). Page
        windows are *disjoint* spans of the range (a span near the shard
        edge is masked, not shifted), so paging never double-reports a
        triple.
        """
        window = max(1, min(window, self.shard_n))

        def step(triples, valid, keys, pats, pat_valid, base_vec,
                 lo_key, hi_key, page_idx):
            start, end = _search(keys, lo_key, hi_key)
            win, win_valid, in_span = _window_slice(
                triples, valid, start, end, page_idx, window)
            page, count = _local_brtpf(win, pats, pat_valid, base_vec,
                                       win_valid & in_span, capacity)
            return page[..., list(wild_cols)], count, end - start

        return step

    def grouped_step(self, index: ShardIndex, slots: torch.Tensor,
                     base_vec: torch.Tensor, live: int, groups: int,
                     width: int, *, spans: Optional[torch.Tensor] = None,
                     rows: Optional[torch.Tensor] = None,
                     count_only: bool = False
                     ) -> Tuple[np.ndarray,
                                List[Tuple[np.ndarray, np.ndarray]]]:
        """The grouped windowed step over a chunk of P window pages.

        One step in place of the reference's windowed, routed and
        sub-window compacted grouped steps: one bind-join launch over the
        chunk's pages of every shard, reading ``index``'s rows where they
        lie. Per (page, shard) the chunk gives an owned span (``spans``
        int64 [P, S, 2]: the windowed pages' ``[start + page * window,
        min(start + (page + 1) * window, end))`` from the on-device
        search, or a routed round's host-routed span, (0, 0) for an idle
        shard) or a row list (``rows`` int32 [P, S, width], -1 padding:
        compact pages' live rows). ``slots``/``live`` come from
        ``kops.pack_slots``. One compaction and one device-to-host copy
        follow; a count-only chunk copies back only ``cnt``.

        Returns the groups' Definition-2 ``cnt`` (int64 [groups]) and,
        unless ``count_only``, per group its kept rows (int32 [K, 3]) and
        their first-matching slots, page by page, then shard by shard.
        """
        _trace.phase("copy_in")
        mask, first, cnt, _ = kops.bindjoin_grouped_cuda(
            index.triples, index.valid, slots, base_vec, live=live,
            width=width, spans=spans, rows=rows)
        _trace.phase("collect")

        def kept_rows(cells):
            p, s, r = cells[:, 0], cells[:, 1], cells[:, 3]
            pos = spans[p, s, 0] + r if rows is None \
                else rows[p, s, r].to(torch.int64)
            return index.triples[s, pos]

        cnts, kept = grouped_results(mask, first, cnt, groups, count_only,
                                     payload=kept_rows)
        return cnts[0], kept[0] if kept else []

    def fused_step(self, index: ShardIndex, slots: torch.Tensor,
                   base_vecs: torch.Tensor, live: int, groups: int,
                   width: int, spans: torch.Tensor,
                   seg_of_page: torch.Tensor,
                   gathered: Optional[torch.Tensor] = None,
                   count_only: bool = False
                   ) -> Tuple[np.ndarray, List[List[Tuple[np.ndarray,
                                                         np.ndarray]]]]:
        """The fused windowed step over a chunk of P window pages of
        several segments (the requests of one index order).

        One fused bind-join launch over the chunk's pages of every shard,
        reading ``index``'s rows where they lie: page p is a window of
        segment ``seg_of_page[p]`` (int32 [P] on the device) with owned
        spans ``spans[p]`` (int64 [P, S, 2]), matched against that
        segment's slot table (``slots`` int32 [Sseg, G, Mp, 4]) and base
        pattern (``base_vecs`` int32 [Sseg, 8]). Pages of a segment that
        only counts (0 in ``gathered``, uint8 [P]; None: none) keep no
        cell. One
        compaction and one device-to-host copy follow; a chunk that only
        counts copies back only ``cnt``.

        Returns ``cnt`` (int64 [Sseg, groups]) and, unless
        ``count_only``, per segment and group its kept rows (int32
        [K, 3]) and their first-matching slots, in round, shard, row
        order (pages come in round order).
        """
        _trace.phase("copy_in")
        mask, first, cnt, _ = kops.bindjoin_fused_cuda(
            index.triples, index.valid, slots, base_vecs, spans=spans,
            seg_of_page=seg_of_page, width=width, live=live)
        _trace.phase("collect")
        if gathered is not None and not count_only:
            mask *= gathered[:, None, None, None]

        def kept_rows(cells):
            p, s, r = cells[:, 0], cells[:, 1], cells[:, 3]
            return index.triples[s, spans[p, s, 0] + r]

        return grouped_results(mask, first, cnt, groups, count_only,
                               payload=kept_rows, seg_of_page=seg_of_page,
                               segments=slots.shape[0])

    def execute_windowed(self, tp: TriplePattern,
                         omega: Optional[np.ndarray], max_mpr: int,
                         capacity: int, window: int) -> np.ndarray:
        """Run the windowed path end-to-end: disjoint window pages until
        every shard's bound-prefix range is covered, with client-side
        reconstruction of projected columns.

        Returns the fragment's data-triple sequence byte-identical
        (values AND order) to ``selectors.brtpf_select_with_cnt``.
        ``capacity`` is accepted for interface symmetry with
        :meth:`execute_full` but the per-window page capacity is the
        window itself, so results are never truncated.
        """
        del capacity  # windowed pages are capacity-safe by construction
        insts = instantiate_patterns(tp, omega)
        if len(insts) > max_mpr:
            raise ValueError(f"{len(insts)} instantiations > maxMpR")
        selector = ShardedSelector(self, window=window)
        data, _cnt = selector.select_with_cnt(tp, omega, insts)
        return data


class ShardStep:
    """One rank's request step over a device mesh: the counterpart of
    the reference's ``shard_map`` steps (``FederatedStore.lowerable`` /
    ``lowerable_windowed``).

    ``local(...)`` runs the kernels on this rank's own partition, given
    as a one-shard store (``[1, shard_n, 3]`` rows, ``[1, shard_n]``
    valid flags and keys), exactly as the single-device logical-shard
    steps do; ``gather(*outputs)`` all-gathers them over the mesh's
    ``axis`` with functional collectives (the response wire transfer),
    in the reference's wire dtypes: int32 pages and range lengths, int64
    counts. Calling the step does both."""

    def __init__(self, mesh, axis: str, local) -> None:
        self.mesh = mesh
        self.axis = axis
        self.local = local

    def gather(self, *outputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        from torch.distributed import _functional_collectives as funcol
        gather = getattr(funcol, "all_gather_single",
                         funcol.all_gather_tensor)
        group = self.mesh.get_group(self.axis)
        return tuple(funcol.wait_tensor(gather(x, 0, group))
                     for x in outputs)

    def __call__(self, *args) -> Tuple[torch.Tensor, ...]:
        return self.gather(*self.local(*args))


def distributed_step(mesh, capacity: int, *, axis: str = "data",
                     window: Optional[int] = None, shard_n: int = 0,
                     wild_cols: tuple = (0, 1, 2)) -> ShardStep:
    """The rank's step of a store sharded over ``axis`` of ``mesh``.

    Without ``window``: the full-shard stream, ``local(triples, valid,
    pats, pat_valid, base_vec) -> (page [1, capacity, 3], count [1])``.
    With ``window`` (clamped to ``shard_n``): the windowed step,
    ``local(triples, valid, keys, pats, pat_valid, base_vec, lo_key,
    hi_key, page_idx) -> (page [1, capacity, len(wild_cols)], count [1],
    range length [1])``."""
    if window is None:
        def local(triples, valid, pats, pat_valid, base_vec):
            page, count = _local_brtpf(triples, pats, pat_valid, base_vec,
                                       valid, capacity)
            return page, count.to(torch.int64)

        return ShardStep(mesh, axis, local)
    window = max(1, min(window, shard_n))

    def local_windowed(triples, valid, keys, pats, pat_valid, base_vec,
                       lo_key, hi_key, page_idx):
        start, end = _search(keys, lo_key, hi_key)
        win, win_valid, in_span = _window_slice(
            triples, valid, start, end, page_idx, window)
        page, count = _local_brtpf(win, pats, pat_valid, base_vec,
                                   win_valid & in_span, capacity)
        return (page[..., list(wild_cols)], count.to(torch.int64),
                (end - start).to(torch.int32))

    return ShardStep(mesh, axis, local_windowed)


def _window_slice(cand, cand_valid, start, end, pi: int, window: int):
    """Slice window ``pi`` of every shard's local range [start, end).

    ``cand`` is [shards, n, 3], ``start``/``end`` int64 [shards]. The
    span ``[start + pi*window, min(start + (pi+1)*window, end))`` is what
    this page *owns*; the physical slice start is clamped into the array
    so the slice never clips, and ``in_span`` masks the slice back to
    the owned span (int64 positions) -- spans are disjoint across pages
    and exactly tile the range, so no triple is reported twice and none
    is skipped.
    """
    shard_n = cand.shape[1]
    span_lo = start + int(pi) * window
    slice_start = span_lo.clamp(0, max(shard_n - window, 0))
    pos = (torch.arange(window, dtype=torch.int64, device=cand.device)[None]
           + slice_start[:, None])
    in_span = (pos >= span_lo[:, None]) & (
        pos < torch.minimum(span_lo + window, end)[:, None])
    return _shard_rows(cand, pos), _shard_rows(cand_valid, pos), in_span


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _subtract_interval(spans: List[Tuple[int, int]], a: int,
                       b: int) -> List[Tuple[int, int]]:
    """Remove [a, b) from a sorted list of disjoint [lo, hi) spans."""
    out: List[Tuple[int, int]] = []
    for lo, hi in spans:
        if hi <= a or lo >= b:
            out.append((lo, hi))
            continue
        if lo < a:
            out.append((lo, a))
        if hi > b:
            out.append((b, hi))
    return out


def _chop_spans(spans: List[List[Tuple[int, int]]],
                window: int) -> Tuple[List[List[Tuple[int, int]]], int]:
    """Chop each shard's spans into window-sized chunks; returns the
    per-shard chunk lists and the number of launch rounds (the longest
    shard's chunk count -- shards with fewer chunks idle in later
    rounds)."""
    chunks: List[List[Tuple[int, int]]] = []
    for shard_spans in spans:
        cs: List[Tuple[int, int]] = []
        for lo, hi in shard_spans:
            p = lo
            while p < hi:
                q = min(p + window, hi)
                cs.append((p, q))
                p = q
        chunks.append(cs)
    rounds = max((len(c) for c in chunks), default=0)
    return chunks, rounds


def _pow2_array(n: np.ndarray) -> np.ndarray:
    """``_pow2`` of every element of a positive int64 array."""
    return np.left_shift(1, np.frexp(n - 1)[1]).astype(np.int64)


def _live_before(lo: np.ndarray, hi: np.ndarray, cum: np.ndarray,
                 x: np.ndarray) -> np.ndarray:
    """Rows at positions below each ``x`` inside the sorted, disjoint
    spans ``[lo, hi)`` (``cum``: their cumulative lengths, from 0):
    every span that ends at or before ``x``, and the part of the one
    span that ``x`` falls inside."""
    j = np.searchsorted(hi, x, side="right")
    inside = j < lo.size
    part = x[inside] - lo[j[inside]]
    out = cum[j]
    out[inside] += np.maximum(part, 0)
    return out


class PageTable:
    """One :class:`WindowPlan`'s pages, shard by shard, computed once.

    ``rows`` (int64 [pages, shards]) holds the live rows of each planned
    page's owned span ``[start + page * window, min(... + window, end))``
    on each shard: the rows inside the plan's merged sub-range spans for
    a pruned plan, the whole span otherwise (0 where the page lies past
    the shard's range). A shard had work in a page iff its entry is
    positive. A pruned page's counts come from one ``searchsorted`` of
    the pages' bounds against each shard's sorted, disjoint spans and
    their cumulative lengths, so no span is visited once per page.

    :meth:`row_lists` gives the sub-window compaction plan of every page
    (docs/fusion.md): where the widest shard's live rows, padded to a
    power of two ``wc``, fit in half the window, the int32 [shards, wc]
    row list (-1 padding) that the grouped step reads in place of the
    page's span; otherwise None and the page streams its span.
    """

    def __init__(self, plan: WindowPlan, window: int, shards: int) -> None:
        self.window = window
        pages = np.asarray(plan.pages, dtype=np.int64)
        self.rows = np.zeros((pages.size, shards), dtype=np.int64)
        # per shard: (its spans' starts, their cumulative lengths, the
        # live rows before each page's owned span); pruned plans only
        self._live: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        if plan.shard_bounds is None or not pages.size:
            return
        bounds = np.asarray(plan.shard_bounds, dtype=np.int64).reshape(-1, 2)
        plo = bounds[None, :, 0] + pages[:, None] * window   # [pages, shards]
        phi = np.maximum(np.minimum(plo + window, bounds[None, :, 1]), plo)
        if not plan.pruned or plan.shard_spans is None:
            self.rows[:] = phi - plo
            return
        for s, spans in enumerate(plan.shard_spans):
            spans = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
            lo, hi = spans[spans[:, 1] > spans[:, 0]].T
            cum = np.zeros((lo.size + 1,), dtype=np.int64)
            np.cumsum(hi - lo, out=cum[1:])
            first = _live_before(lo, hi, cum, plo[:, s])
            self.rows[:, s] = _live_before(lo, hi, cum, phi[:, s]) - first
            self._live.append((lo, cum, first))

    def row_lists(self) -> List[Optional[np.ndarray]]:
        """Per page its compact row list, or None (see the class)."""
        out: List[Optional[np.ndarray]] = [None] * self.rows.shape[0]
        if not self._live:
            return out
        wc = _pow2_array(np.maximum(self.rows.max(axis=1), 1))
        compact = wc <= self.window // 2
        for width in np.unique(wc[compact]):
            idx = np.flatnonzero(compact & (wc == width))
            cols = np.arange(width)[None, :]
            sel = np.full((idx.size, len(self._live), int(width)), -1,
                          dtype=np.int32)
            for s, (lo, cum, first) in enumerate(self._live):
                if not lo.size:
                    continue
                # the page's live rows are the shard's live rows of rank
                # first .. first + rows - 1, in span order
                rank = first[idx, None] + cols
                k = np.minimum(np.searchsorted(cum[1:], rank, side="right"),
                               lo.size - 1)
                sel[:, s] = np.where(cols < self.rows[idx, s, None],
                                     lo[k] + rank - cum[k], -1)
            for i, p in enumerate(idx):
                out[p] = sel[i]
        return out


def _row_list_chunks(sels: List[np.ndarray], shards: int):
    """Consecutive compact pages' row lists (int32 [shards, wc] each) in
    chunks of at most ``MAX_CHUNK_ROWS`` rows once padded to the chunk's
    widest list; yields (row lists, width)."""
    chunk: List[np.ndarray] = []
    width = 0
    for sel in sels:
        w = max(width, sel.shape[1])
        if chunk and (len(chunk) + 1) * shards * w > MAX_CHUNK_ROWS:
            yield chunk, width
            chunk, w = [], sel.shape[1]
        chunk.append(sel)
        width = w
    if chunk:
        yield chunk, width


class ShardedSelector:
    """Sharded windowed selector with the KernelSelector contract.

    Serves the bindings-restricted selector from a
    :class:`FederatedStore` without ever materializing a candidate
    range: each launch streams one ``window`` per shard, G same-pattern
    requests share the launch (grouped geometry), and the host epilogue
    (:func:`~repro_torch.core.kernel_selectors.stream_order` over the
    shards' kept rows + first-match indices) makes the returned
    data-triple sequence and Definition-2 ``cnt`` byte-identical to
    ``selectors.brtpf_select_with_cnt``.

    Why parity holds across shards: the store partitions the triples,
    so every triple is evaluated on exactly one shard, and page spans
    are disjoint within a shard -- each matching triple is kept exactly
    once, with the same first-matching-pattern stream id the single-host
    kernel computes; the epilogue's (stream, packed-key) sort is a total
    order, so concatenation order across shards/windows is irrelevant.
    ``cnt`` sums the per-row matching-pattern counts over all shards,
    which equals the oracle's sum of per-instantiation stream sizes.

    ``launches`` records one :class:`LaunchRecord` per window page (or
    routed round) with ``cand_streamed = window`` -- the rows ONE shard
    streams -- so the accounting surface (and the budgets gated on it)
    is the JAX package's and is shared with the single-host kernel
    path. The card sees fewer launches: one grouped bind-join launch
    per chunk of a request's pages (``grouped_chunks`` counts them),
    and one fused launch per chunk of an order group's rounds
    (``fused_chunks``), against one LaunchRecord per round.

    Omega-restricted pruning (docs/pruning.md): every request is
    launched from a host-side :class:`WindowPlan` -- the POS/OSP
    mirrors let the plan pick the order with the longest bound prefix
    (unbound-subject patterns stop scanning whole shards), and window
    pages disjoint from every per-binding sub-range are skipped
    outright. With ``store`` connected and ``fast_path_rows`` > 0,
    plans whose relevant row count falls below the threshold are served
    by the numpy block evaluation instead of launching windows.
    """

    def __init__(self, fed: FederatedStore,
                 window: int = DEFAULT_SHARD_WINDOW,
                 fragments: Optional[FragmentStore] = None,
                 store=None, fast_path_rows: int = 0,
                 heat: Optional[HeatLog] = None) -> None:
        self.fed = fed
        self.window = max(1, min(int(window), fed.shard_n))
        self.fragments = fragments
        self.store = store
        self.fast_path_rows = int(fast_path_rows)
        self.launches: List[LaunchRecord] = []
        # Grouped bind-join launches made: one per chunk of a request's
        # window pages (``MAX_CHUNK_ROWS``), against one LaunchRecord
        # per page in ``launches``.
        self.grouped_chunks = 0
        # Fused bind-join launches made: one per chunk of an order
        # group's (round, segment) pages, against one LaunchRecord per
        # round in ``launches``.
        self.fused_chunks = 0
        # What the CUDA kernels did: launches (grouped_chunks +
        # fused_chunks) and each LaunchRecord's live slots.
        self.cuda = CudaWork()
        # Placement surfaces (docs/federation.md, "Placement"): the
        # bounded heat log the re-partitioner consumes, and per-shard
        # attribution counters -- launches a shard had work in, candidate
        # rows it streamed, and planned window pages it owned.
        self.heat = heat
        self.shard_launches = np.zeros((fed.shards,), dtype=np.int64)
        self.shard_rows = np.zeros((fed.shards,), dtype=np.int64)
        self.shard_pages = np.zeros((fed.shards,), dtype=np.int64)

    # -- placement surfaces (docs/federation.md, "Placement") ---------------

    def shard_balance(self) -> dict:
        """JSON-safe per-shard balance snapshot (metrics ``shards``)."""
        from .metrics import shard_balance
        return shard_balance(self.shard_launches.tolist(),
                             self.shard_rows.tolist(),
                             self.shard_pages.tolist())

    def reset_shard_counters(self) -> None:
        self.shard_launches[:] = 0
        self.shard_rows[:] = 0
        self.shard_pages[:] = 0

    def rebind(self, fed: FederatedStore) -> None:
        """Cutover to a repartitioned store: swap the federation, clamp
        the window to the new shard size, and restart the per-shard
        attribution (old counts were measured against old boundaries).
        The heat log is kept -- it describes the workload, not the
        partitioning."""
        self.fed = fed
        self.window = max(1, min(self.window, fed.shard_n))
        self.shard_launches = np.zeros((fed.shards,), dtype=np.int64)
        self.shard_rows = np.zeros((fed.shards,), dtype=np.int64)
        self.shard_pages = np.zeros((fed.shards,), dtype=np.int64)

    def _charge_pages(self, table: PageTable) -> None:
        """Attribute a plan's window pages to the shards that had work
        in them: per shard the pages it had live rows in, and the rows."""
        worked = (table.rows > 0).sum(axis=0)
        self.shard_launches += worked
        self.shard_pages += worked
        self.shard_rows += table.rows.sum(axis=0)

    def _routed_spans(self, plan: WindowPlan) -> List[List[Tuple[int, int]]]:
        """Per-shard live [lo, hi) position spans for the routed path,
        with every overlapping replica range deduped to its least-loaded
        owner (the other holders get the range subtracted -- a pair of
        binary searches, since each holder's copy is sorted)."""
        fed = self.fed
        hk = fed.indexes[plan.order].host_keys
        shards = hk.shape[0]
        spans: List[List[Tuple[int, int]]] = []
        if plan.pruned and plan.shard_spans is not None:
            for sp in plan.shard_spans:
                spans.append([(int(a), int(b)) for a, b in
                              np.asarray(sp).reshape(-1, 2) if b > a])
        elif plan.shard_bounds is not None:
            spans = [[(int(a), int(b))] if b > a else []
                     for a, b in plan.shard_bounds]
        else:
            for s in range(shards):
                a = int(np.searchsorted(hk[s], plan.lo_key, side="left"))
                b = int(np.searchsorted(hk[s], plan.hi_key, side="right"))
                spans.append([(a, b)] if b > a else [])
        placement = fed.placement
        if placement is None:
            return spans
        for rr in placement.replicas.get(plan.order, ()):
            if rr.hi_key < plan.lo_key or rr.lo_key > plan.hi_key:
                continue
            holders = rr.holders
            owner = min(holders,
                        key=lambda s: (int(self.shard_pages[s]), s))
            for s in holders:
                if s == owner:
                    continue
                a = int(np.searchsorted(hk[s], rr.lo_key, side="left"))
                b = int(np.searchsorted(hk[s], rr.hi_key, side="right"))
                if b > a:
                    spans[s] = _subtract_interval(spans[s], a, b)
        return spans

    # -- public API (same contract as KernelSelector) ------------------------

    def select_with_cnt(
        self, tp: TriplePattern, omega: Optional[np.ndarray],
        insts: Optional[List[TriplePattern]] = None,
    ) -> Tuple[np.ndarray, int]:
        """Sharded ``brtpf_select_with_cnt`` (byte-identical)."""
        return self.select_same_pattern(
            tp, [omega], None if insts is None else [insts])[0]

    def select_same_pattern(
        self, tp: TriplePattern, omegas: Sequence[Optional[np.ndarray]],
        patterns: Optional[List[List[TriplePattern]]] = None,
    ) -> List[Tuple[np.ndarray, int]]:
        """Serve G same-pattern requests from one sharded launch per
        chunk of window pages. Returns per-request (data sequence, cnt), each
        identical to ``brtpf_select_with_cnt(store, tp, omega_g)``.

        Groups resident in the connected fragment store never launch a
        window: their share is recorded as skipped (same contract as
        :class:`~repro_torch.core.kernel_selectors.KernelSelector`)."""
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
        """Count-only sharded selection: Definition-2 ``cnt``, no row
        gather, no kept pages copied back (docs/fusion.md)."""
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

    def _launch_groups(
        self, tp: TriplePattern, omegas: Sequence[Optional[np.ndarray]],
        patterns: List[List[TriplePattern]],
        count_only: bool = False,
    ) -> List[Tuple[np.ndarray, int]]:
        """Windowed sharded launches over the store-miss groups."""
        all_insts = [p for group in patterns for p in group]
        plan = self.fed.plan_windows(tp, all_insts, self.window)
        return self._launch_plan(tp, patterns, plan,
                                 count_only=count_only)

    def _gather_fast_block(self, tp: TriplePattern,
                           all_insts: List[TriplePattern]) -> np.ndarray:
        """Host-side pruned candidate block for the small-work path."""
        sr = self.store.subranges(tp, insts=all_insts)
        if sr is not None and sr.rows < len(
                self.store.candidate_range(tp)):
            return self.store.gather_subranges(sr)
        return self.store.candidate_range(tp).triples

    def _launch_plan(
        self, tp: TriplePattern, patterns: List[List[TriplePattern]],
        plan: WindowPlan, count_only: bool = False,
    ) -> List[Tuple[np.ndarray, int]]:
        """Execute one planned (grouped) request: fast path or windows."""
        _trace.phase("prep")
        g = len(patterns)
        m = max(len(p) for p in patterns)
        window = self.window
        if not plan.pages:
            # no window can contain a match on any shard (empty range,
            # or every sub-range empty): zero launches, cnt = 0
            return [(_EMPTY, 0)] * g

        # Small-work fast path: the plan's relevant rows cannot pay for
        # window dispatches -- evaluate the groups over the pruned block
        # gathered from the (host) oracle store instead.
        if (self.store is not None
                and 0 < plan.candidate_rows <= self.fast_path_rows):
            block = self._gather_fast_block(
                tp, [p for group in patterns for p in group])
            self.launches.append(LaunchRecord(
                cand_streamed=int(block.shape[0]), pat_slots=0, groups=g,
                pruned=plan.pruned, cand_full=plan.range_rows,
                fast_path=True))
            return select_block_numpy(block, tp, patterns,
                                      count_only=count_only)

        # pad the grid to bucketed shapes (the reference's geometry):
        # groups to a power of two, pattern slots to the kernel m-tile.
        gpad = _pow2(g)
        mp = kops.padded_pattern_slots(m)
        pats, valid, base_vec = marshal_pattern_grid(tp, patterns,
                                                     gpad, mp)
        slots, live = kops.pack_slots(pats, valid, mp)
        live_g = live_slot_count(valid)
        index = self.fed.indexes[plan.order]
        shards = self.fed.shards
        dev = self.fed.device
        _trace.phase("copy_in")
        slots_d = _to(slots, dev)
        bv_d = _to(base_vec, dev)
        _trace.phase("prep")
        kept: List[List[np.ndarray]] = [[] for _ in range(g)]
        firsts: List[List[np.ndarray]] = [[] for _ in range(g)]
        cnt_total = np.zeros((g,), dtype=np.int64)

        def launch(width: int, **where) -> None:
            # one grouped launch over a chunk of pages (or rounds)
            self.grouped_chunks += 1
            self.cuda.launches += 1
            cnts, per_group = self.fed.grouped_step(
                index, slots_d, bv_d, live, g, width,
                count_only=count_only, **where)
            cnt_total[:] += cnts
            for gi, (rows_g, first_g) in enumerate(per_group):
                if rows_g.shape[0]:
                    kept[gi].append(rows_g)
                    firsts[gi].append(first_g)

        # The accounting is the reference's: one LaunchRecord and one
        # charge per window page (or routed round), in page order.
        per_chunk = max(1, MAX_CHUNK_ROWS // (shards * window))
        if self.fed.placement is not None:
            # workload-aware placement: explicit per-shard spans with
            # replica ranges routed to one owner each
            chunks, rounds = _chop_spans(self._routed_spans(plan), window)
            round_spans = np.zeros((rounds, shards, 2), dtype=np.int64)
            for r in range(rounds):
                self.launches.append(LaunchRecord(
                    cand_streamed=window, pat_slots=gpad * mp,
                    groups=g, pruned=plan.pruned, cand_full=window))
                self.cuda.live_slots += live_g
                for s, cs in enumerate(chunks):
                    if r < len(cs):
                        a, b = cs[r]
                        round_spans[r, s] = (a, b)
                        self.shard_launches[s] += 1
                        self.shard_pages[s] += 1
                        self.shard_rows[s] += b - a
            for r0 in range(0, rounds, per_chunk):
                _trace.phase("copy_in")
                launch(window,
                       spans=_to(round_spans[r0:r0 + per_chunk], dev))
            n_launched = rounds
        else:
            # runs of consecutive pages of one kind (spans or compact row
            # lists) keep the page order; each run goes in chunks
            runs: List[Tuple[bool, list]] = []
            table = PageTable(plan, window, shards)
            self._charge_pages(table)
            for page_idx, row_sel in zip(plan.pages, table.row_lists(),
                                         strict=True):
                if row_sel is not None:
                    # sub-window compaction: gather only the live rows
                    wc = row_sel.shape[1]
                    self.launches.append(LaunchRecord(
                        cand_streamed=wc, pat_slots=gpad * mp, groups=g,
                        pruned=True, cand_full=window,
                        reclaimed_rows=window - wc))
                else:
                    self.launches.append(LaunchRecord(
                        cand_streamed=window, pat_slots=gpad * mp,
                        groups=g, pruned=plan.pruned, cand_full=window))
                self.cuda.live_slots += live_g
                compact = row_sel is not None
                if not runs or runs[-1][0] != compact:
                    runs.append((compact, []))
                runs[-1][1].append(row_sel if compact else page_idx)
            n_launched = len(plan.pages)
            # the bound-prefix range, searched once per request on the
            # device (the host keys only chose the pages)
            _trace.phase("copy_in")
            start, end = _search(index.keys, plan.lo_key, plan.hi_key)
            for compact, items in runs:
                if compact:
                    for sels, width in _row_list_chunks(items, shards):
                        _trace.phase("prep")
                        rows = np.full((len(sels), shards, width), -1,
                                       dtype=np.int32)
                        for i, sel in enumerate(sels):
                            rows[i, :, :sel.shape[1]] = sel
                        _trace.phase("copy_in")
                        launch(width, rows=_to(rows, dev))
                    continue
                for i in range(0, len(items), per_chunk):
                    _trace.phase("copy_in")
                    pages = _to(np.asarray(items[i:i + per_chunk],
                                           dtype=np.int64), dev)
                    lo = start[None, :] + pages[:, None] * window
                    hi = torch.minimum(lo + window, end[None, :])
                    launch(window, spans=torch.stack([lo, hi], dim=-1))
        if self.heat is not None and n_launched:
            self.heat.record(plan.order, plan.lo_key, plan.hi_key,
                             launches=n_launched,
                             rows=plan.candidate_rows,
                             pages=len(plan.pages))

        _trace.phase("order")
        out: List[Tuple[np.ndarray, int]] = []
        for gi in range(g):
            if count_only or not kept[gi]:
                out.append((_EMPTY, int(cnt_total[gi])))
                continue
            full = np.concatenate(kept[gi], axis=0)
            first_g = np.concatenate(firsts[gi], axis=0)
            out.append((stream_order(full, first_g, patterns[gi]),
                        int(cnt_total[gi])))
        return out

    # -- cross-pattern fusion (docs/fusion.md) -------------------------------

    def select_fused(self, segments: Sequence[FusedSegment]
                     ) -> List[List[Tuple[np.ndarray, int]]]:
        """Serve S heterogeneous segments with fused windowed launches.

        The sharded twin of ``KernelSelector.select_fused``: segments
        are planned individually (residency skips, ``plan_windows``
        page skipping, and the small-work fast path behave exactly as
        unfused), then the launch-worthy segments are grouped BY INDEX
        ORDER -- only same-order segments can share a window slice pass
        -- and each order group runs in rounds: round r streams one
        window page of every segment that still has one (segments with
        fewer planned pages drop out of later rounds), one LaunchRecord
        per round, while the card sees the rounds' pages in chunks, one
        fused launch per chunk (:meth:`FederatedStore.fused_step`).
        ``fusion_legality`` refusals and singleton
        order groups fall back to per-segment ``_launch_plan`` on the
        already-computed plans.
        """
        results: List[List[Optional[Tuple[np.ndarray, int]]]] = [
            [None] * len(seg.omegas) for seg in segments]
        work: List[Tuple[int, List[List[TriplePattern]],
                         List[Optional[np.ndarray]], List[int],
                         WindowPlan]] = []
        for si, seg in enumerate(segments):
            _trace.phase("prep")
            patterns = seg.patterns
            if patterns is None:
                patterns = [instantiate_patterns(seg.tp, om)
                            for om in seg.omegas]
            live = consult_segment(self.fragments, seg, results[si],
                                   self.launches)
            if not live:
                continue
            omegas_live = [seg.omegas[i] for i in live]
            pats_live = [patterns[i] for i in live]
            all_insts = [p for group in pats_live for p in group]
            plan = self.fed.plan_windows(seg.tp, all_insts, self.window)
            if not plan.pages:
                _trace.phase("serve")
                finish_segment(self.fragments, seg, omegas_live,
                               [(_EMPTY, 0)] * len(live), results[si],
                               live)
                continue
            if (self.store is not None
                    and 0 < plan.candidate_rows <= self.fast_path_rows):
                block = self._gather_fast_block(seg.tp, all_insts)
                self.launches.append(LaunchRecord(
                    cand_streamed=int(block.shape[0]), pat_slots=0,
                    groups=len(live), pruned=plan.pruned,
                    cand_full=plan.range_rows, fast_path=True))
                fresh = select_block_numpy(block, seg.tp, pats_live,
                                           count_only=seg.count_only)
                _trace.phase("serve")
                finish_segment(self.fragments, seg, omegas_live, fresh,
                               results[si], live)
                continue
            work.append((si, pats_live, omegas_live, live, plan))
        if not work:
            return results

        _trace.phase("prep")
        # Legality: declared dependencies refuse the whole batch
        # (conservative -- DaCe-style fusion only for independent
        # states); geometry ceilings are checked per order group below.
        dep_reason = fusion_legality(
            [segments[w[0]] for w in work], stream_rows=0, slot_table=0)

        by_order: Dict[str, List] = {}
        for item in work:
            by_order.setdefault(item[4].order, []).append(item)
        wp = _pow2(self.window)
        for items in by_order.values():
            s_pad = _pow2(len(items))
            g_pad = _pow2(max(len(w[3]) for w in items))
            m_max = max(max(len(p) for p in w[1]) for w in items)
            mp = kops.padded_pattern_slots(m_max)
            reason = dep_reason or fusion_legality(
                [segments[w[0]] for w in items],
                stream_rows=s_pad * wp,
                slot_table=s_pad * g_pad * mp)
            if (len(items) == 1 or reason is not None
                    or self.fed.placement is not None):
                # documented fallback: per-segment grouped launches on
                # the plans already in hand (no re-probe, no re-plan).
                # A workload-aware placement always falls back: the
                # fused step derives spans on device from (lo, hi) keys
                # and cannot honor per-shard replica routing.
                for si, pats_live, omegas_live, live, plan in items:
                    seg = segments[si]
                    fresh = self._launch_plan(seg.tp, pats_live, plan,
                                              count_only=seg.count_only)
                    _trace.phase("serve")
                    finish_segment(self.fragments, seg, omegas_live,
                                   fresh, results[si], live)
                continue
            self._launch_fused_order(items, segments, results, g_pad, mp)
        return results

    def _launch_fused_order(self, items, segments, results, g_pad: int,
                            mp: int) -> None:
        """Run one order group's fused windowed rounds + epilogue.

        Round r streams page ``pages[r]`` of every segment that still has
        one. The host accounting is the reference's, one LaunchRecord per
        round; the device sees the rounds' pages in round order, in
        chunks of ``MAX_CHUNK_ROWS`` (pages x shards x window), one fused
        launch, compaction and copy per chunk.
        """
        _trace.phase("prep")
        window = self.window
        wp = _pow2(window)
        s = len(items)
        order = items[0][4].order
        index = self.fed.indexes[order]
        shards = self.fed.shards
        dev = self.fed.device
        grids = [marshal_pattern_grid(segments[si].tp, pats_live, g_pad, mp)
                 for si, pats_live, _om, _live, _plan in items]
        slots, live = kops.pack_slots(
            np.concatenate([pg for pg, _v, _b in grids]),
            np.concatenate([v for _p, v, _b in grids]), mp)
        seg_live = [live_slot_count(v) for _p, v, _b in grids]
        _trace.phase("copy_in")
        slots_d = _to(slots.reshape(s, g_pad, mp, 4), dev)
        bvs_d = _to(np.stack([b for _p, _v, b in grids]), dev)
        _trace.phase("prep")
        for _si, _pl, _om, _live, plan in items:
            if self.heat is not None and plan.pages:
                self.heat.record(plan.order, plan.lo_key, plan.hi_key,
                                 launches=len(plan.pages),
                                 rows=plan.candidate_rows,
                                 pages=len(plan.pages))
            self._charge_pages(PageTable(plan, window, shards))

        # the pages of every round, round-major: (segment, page index)
        pages: List[Tuple[int, int]] = []
        rounds = max(len(w[4].pages) for w in items)
        for r in range(rounds):
            active = [wi for wi in range(s) if r < len(items[wi][4].pages)]
            self.launches.append(LaunchRecord(
                cand_streamed=len(active) * wp,
                pat_slots=g_pad * mp,
                groups=sum(len(items[wi][3]) for wi in active),
                pruned=any(items[wi][4].pruned for wi in active),
                cand_full=len(active) * wp,
                segments=len(active)))
            self.cuda.live_slots += max(seg_live[wi] for wi in active)
            pages += [(wi, items[wi][4].pages[r]) for wi in active]

        # each segment's bound-prefix range, searched once for all shards
        # on the device (the host keys only chose the pages)
        _trace.phase("copy_in")
        keys = torch.tensor([[w[4].lo_key, w[4].hi_key] for w in items],
                            dtype=torch.int64, device=dev)
        start = torch.searchsorted(index.keys, keys[None, :, 0].expand(
            shards, s).contiguous(), side="left").T         # (Sseg, S)
        end = torch.searchsorted(index.keys, keys[None, :, 1].expand(
            shards, s).contiguous(), side="right").T
        counting = [segments[w[0]].count_only for w in items]
        cnt_total = np.zeros((s, g_pad), dtype=np.int64)
        kept: List[List[List[np.ndarray]]] = [[[] for _ in range(g_pad)]
                                              for _ in range(s)]
        firsts: List[List[List[np.ndarray]]] = [[[] for _ in range(g_pad)]
                                                for _ in range(s)]
        per_chunk = max(1, MAX_CHUNK_ROWS // (shards * window))
        for c0 in range(0, len(pages), per_chunk):
            _trace.phase("copy_in")
            chunk = np.asarray(pages[c0:c0 + per_chunk], dtype=np.int64)
            only_counts = [counting[wi] for wi in chunk[:, 0]]
            seg_d = _to(chunk[:, 0], dev)
            lo = start[seg_d] + _to(chunk[:, 1], dev)[:, None] * window
            hi = torch.minimum(lo + window, end[seg_d])
            gathered = None
            if any(only_counts) and not all(only_counts):
                gathered = _to(np.logical_not(only_counts), dev,
                               torch.uint8)
            self.fused_chunks += 1
            self.cuda.launches += 1
            cnts, per_seg = self.fed.fused_step(
                index, slots_d, bvs_d, live, g_pad, window,
                torch.stack([lo, hi], dim=-1), seg_d.to(torch.int32),
                gathered=gathered, count_only=all(only_counts))
            cnt_total += cnts
            for wi, per_group in enumerate(per_seg):
                for gi, (rows_g, first_g) in enumerate(per_group):
                    if rows_g.shape[0]:
                        kept[wi][gi].append(rows_g)
                        firsts[wi][gi].append(first_g)

        for wi, (si, pats_live, omegas_live, live_g, _plan) in \
                enumerate(items):
            _trace.phase("order")
            seg = segments[si]
            fresh: List[Tuple[np.ndarray, int]] = []
            for gi in range(len(live_g)):
                cnt = int(cnt_total[wi, gi])
                if seg.count_only or not kept[wi][gi]:
                    fresh.append((_EMPTY, cnt))
                    continue
                full = np.concatenate(kept[wi][gi], axis=0)
                first_g = np.concatenate(firsts[wi][gi], axis=0)
                fresh.append((stream_order(full, first_g,
                                           pats_live[gi]), cnt))
            _trace.phase("serve")
            finish_segment(self.fragments, seg, omegas_live, fresh,
                           results[si], live_g)
