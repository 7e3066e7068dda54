"""The combined TPF/brTPF server (paper section 4.1).

One servlet-equivalent component serves both interfaces: a request with a
bindings-restricted selector takes the brTPF path, a plain triple-pattern
request takes the TPF path. Shared machinery (paging, metadata triples,
accounting) is common to both so comparisons are fair -- mirroring the
paper's single-servlet design.

Requests and responses are value objects; the "HTTP layer" is the
``handle`` call boundary, and network metrics are charged per page
exactly as in section 5.1.

``selector_backend`` selects how the origin server evaluates the
bindings-restricted selector:

* ``"numpy"`` -- the paper-faithful per-instantiated-pattern backend
  loop (``selectors.brtpf_select_with_cnt``); kept as the parity oracle.
* ``"kernel"`` -- the hand-written CUDA bind-join kernels over the
  store's packed candidate range (``kernel_selectors.KernelSelector``,
  on ``ServerConfig.device``); byte-identical fragments, one pass per
  request, and ``handle_batch`` coalesces concurrent same-pattern
  requests into one grouped launch and heterogeneous ones into one
  fused launch.
* ``"sharded"`` -- the windowed selector over a store split into
  ``ServerConfig.shards`` logical shards on the device
  (``federation.ShardedSelector`` over a ``FederatedStore``): each
  launch streams one fixed ``shard_window`` of every shard's sorted
  range (per-shard work bounded by the window, never by range or shard
  size), and ``handle_batch`` coalescing rides the same grouped
  geometry. Fragments are byte-identical to both other backends.

The kernel and sharded backends share one selector interface
(``select_with_cnt`` / ``select_same_pattern`` / ``launches``) and one
``LaunchRecord`` accounting surface, so batching, memoization, paging
and the launch-budget gates are backend-agnostic.

This is the port of ``repro.core.server``; ``Request`` speaks the same
brtpf/v1 wire schema (``core/wire.py``).

Every reuse layer -- the HTTP cache's pages, the selector memo and (via
``on_release``) the store's candidate-range memo -- lives in ONE
unified :class:`~repro_torch.core.fragments.FragmentStore` per server: a
kernel or sharded window launch is skipped whenever the requested page is already
resident, regardless of which path populated it
(``Counters.launches_skipped``), and eviction is coherent across layers
(docs/caching.md).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import trace as _trace
from .cache import LRUCache, request_key
from .config import (DEFAULT_MAX_MPR, DEFAULT_META_TRIPLES_PER_PAGE,
                     DEFAULT_PAGE_SIZE, ServerConfig)
from .fragments import FragmentStore
from .metrics import Counters, CudaWork, metrics_snapshot
from .rdf import TriplePattern
from .selectors import (Fragment, brtpf_select_with_cnt,
                        instantiate_patterns, tpf_select)
from .store import TripleStore

__all__ = ["BrTPFServer", "MaxMprExceeded", "Request", "ServerConfig",
           "DEFAULT_MAX_MPR", "DEFAULT_META_TRIPLES_PER_PAGE",
           "DEFAULT_PAGE_SIZE"]


@dataclasses.dataclass(frozen=True)
class Request:
    """A (br)TPF page request.

    ``omega`` is None for pure TPF requests; otherwise an int32 [M, V]
    sequence of solution mappings with M <= maxMpR (server-enforced).

    ``count_only`` asks for the fragment's Definition-2 ``cnt`` metadata
    without its data triples (docs/fusion.md): the response is a normal
    :class:`~repro_torch.core.selectors.Fragment` whose data page is empty.
    Count results live under their own memo key -- a count probe can be
    answered FROM a resident data fragment, but never populates (or
    poisons) the data memo the other way round.

    ``timeout_ms`` is the request's REMAINING deadline budget in
    milliseconds (docs/resilience.md): the batching front end sheds the
    request with :class:`~repro.core.batching.DeadlineExceeded` instead
    of burning a launch on it once the budget is exhausted, and both
    transports bound their wait on it. It deliberately does NOT enter
    :meth:`key`: a fragment's identity is (pattern, omega, page), so a
    retried request with a smaller remaining budget still hits every
    cache/memo layer.
    """

    pattern: TriplePattern
    omega: Optional[np.ndarray] = None
    page: int = 0
    count_only: bool = False
    timeout_ms: Optional[float] = None

    def key(self):
        om = None
        if self.omega is not None:
            om = tuple(map(tuple, np.asarray(self.omega).tolist()))
        if self.count_only:
            # distinct key namespace: real omega_rows is None or a tuple
            # of row-tuples, never a str-tagged pair
            om = ("count", om)
        return request_key(self.pattern.as_tuple(), om, self.page)

    @property
    def is_brtpf(self) -> bool:
        return self.omega is not None and self.omega.shape[0] > 0

    # -- wire schema (brtpf/v1; core/wire.py) -------------------------------

    def to_wire(self) -> dict:
        """brtpf/v1 request envelope (JSON-safe; omega as int lists)."""
        from .wire import request_to_wire
        return request_to_wire(self)

    @staticmethod
    def from_wire(obj: dict) -> "Request":
        """Decode a brtpf/v1 request envelope (strict; raises
        :class:`~repro_torch.core.wire.WireError` on malformed input)."""
        from .wire import request_from_wire
        return request_from_wire(obj)


class MaxMprExceeded(ValueError):
    """HTTP 414 equivalent: too many mappings attached to one request."""


class BrTPFServer:
    """Combined TPF/brTPF server over a :class:`TripleStore`."""

    def __init__(
        self,
        store: TripleStore,
        config: Optional[ServerConfig] = None,
        *,
        cache: Optional[LRUCache] = None,
    ) -> None:
        config = config or ServerConfig()
        self.config = config
        self.store = store
        self.page_size = int(config.page_size)
        self.max_mpr = int(config.max_mpr)
        self.meta_triples_per_page = int(config.meta_triples_per_page)
        self.cache = cache
        self.selector_backend = config.selector_backend
        # Unified fragment store (core/fragments.py): ONE page-granular
        # layer under the HTTP cache, the selector memo and the store's
        # candidate-range memo. The data layer is the selector memo (a
        # real server streams a fragment across its pages instead of
        # recomputing the selection per page request; it is NOT the HTTP
        # cache of section 7 and does not touch its hit/miss metrics);
        # the page layer holds the HTTP cache's rendered pages (the
        # LRUCache binds itself to it below); and when a pattern's last
        # live fragment is evicted, on_release drops the store's
        # candidate range coherently.
        self.fragments = FragmentStore(
            on_release=store.evict_candidate_range)
        if cache is not None:
            cache.bind(self.fragments)
        # Accelerated selector (kernel or sharded backend, on
        # config.device); None for the paper-faithful numpy oracle. Both
        # implementations share the select_with_cnt /
        # select_same_pattern / launches interface, and both consult the
        # unified store before launching.
        self._selector = None
        self._heat = None
        if config.selector_backend == "kernel":
            from .kernel_selectors import KernelSelector
            self._selector = KernelSelector(
                store, fragments=self.fragments,
                fast_path_rows=config.fast_path_rows,
                device=config.device)
        elif config.selector_backend == "sharded":
            from .federation import (DEFAULT_SHARD_WINDOW, FederatedStore,
                                     ShardedSelector)
            from .placement import HeatLog
            self.federated = FederatedStore.build(
                store.triples, shards=config.shards,
                device=config.device, layout=store.layout)
            # placement_policy="heat": record per-range heat from live
            # traffic so repartition() can re-cut shard boundaries
            # (docs/federation.md, "Placement")
            self._heat = (HeatLog(config.heat_capacity)
                          if config.placement_policy == "heat" else None)
            self._selector = ShardedSelector(
                self.federated,
                window=config.shard_window or DEFAULT_SHARD_WINDOW,
                fragments=self.fragments,
                store=store, fast_path_rows=config.fast_path_rows,
                heat=self._heat)
        self.counters = Counters()
        # Memo keys prefilled by the *current* handle_batch call: their
        # subsequent handle() reads are batched work, not cache skips.
        self._prefilled: set = set()
        # Honest per-server range-memo accounting: the store (and its
        # memo counters) may be shared across servers (the benchmarks
        # reuse one dataset store), so this server's metrics report
        # DELTAS from the counts observed at construction/reset --
        # another server's probe traffic must not show up here.
        self._range_base = (store.range_memo_hits, store.range_memo_misses)

    # -- request handling ---------------------------------------------------

    def validate(self, req: Request) -> None:
        """Reject an over-maxMpR request (HTTP 414). Shared by ``handle``,
        ``handle_batch`` and the async batching front end, which must
        validate per request *before* coalescing."""
        if req.omega is not None and req.omega.shape[0] > self.max_mpr:
            raise MaxMprExceeded(
                f"{req.omega.shape[0]} mappings > maxMpR={self.max_mpr}"
            )

    def handle(self, req: Request) -> Fragment:
        """Serve one page request (the HTTP GET boundary)."""
        self.counters.num_requests += 1
        self.validate(req)

        if self.cache is not None:
            cached = self.cache.get(req.key())
            if cached is not None:
                frag = cached  # served by the proxy, not the origin
                if self._selector is not None:
                    self._note_launch_skip()
                self._charge_transfer(frag)
                return frag

        frag = self._compute(req)
        if self.cache is not None:
            self.cache.put(req.key(), frag)
        self._charge_transfer(frag)
        return frag

    def page_resident(self, req: Request) -> bool:
        """Non-counting residency peek: can this page be served without
        origin selector work, from ANY layer of the unified store (a
        registered HTTP page or the fragment's full memo data)? Used by
        the async front end to bypass the batching window -- there is
        nothing to coalesce for a request that launches nothing.

        Delegates to the unified store's own residency notion: pages
        only ever live there (the bound HTTP cache is a view), so one
        definition serves both."""
        return self.fragments.page_resident(req.key())

    def _note_launch_skip(self) -> None:
        """One request served from the unified store that would
        otherwise have reached the accelerated selector."""
        self.counters.launches_skipped += 1
        self.fragments.note_skip()

    def _charge_transfer(self, frag: Fragment) -> None:
        self.counters.data_triples += int(frag.data.shape[0])
        self.counters.meta_triples += frag.meta_triples
        self.counters.data_received += frag.triples_received

    # -- origin-server computation (section 4.1) ----------------------------

    def _compute(self, req: Request) -> Fragment:
        data, cnt = self._fragment_data(req)
        return self._paginate(data, cnt, req)

    def _fragment_data(self, req: Request) -> Tuple[np.ndarray, int]:
        """Memoized selector evaluation: the fragment's full data-triple
        sequence + cnt estimate, page-independent."""
        memo_key = req.key()[:2]  # (pattern, omega) -- page-independent
        memo = self.fragments.get_data(memo_key)
        if memo is not None:
            # work accounting still charges the originating computation
            # only once -- matching the paper's streaming server. A hit
            # on an accelerated backend is a skipped launch, unless
            # this request IS the batch member its selection was just
            # prefilled for (that is coalescing, already counted as
            # batched_requests). The mark is one-shot: a same-key
            # duplicate beyond the consumer is an ordinary store hit.
            if memo_key in self._prefilled:
                self._prefilled.discard(memo_key)
            elif self._selector is not None:
                self._note_launch_skip()
            return memo
        _trace.phase("prep")
        if req.count_only:
            return self._count_data(req, memo_key)
        if req.is_brtpf:
            patterns = instantiate_patterns(req.pattern, req.omega)
            self.counters.server_lookups += len(patterns)
            if self._selector is not None:
                data, cnt = self._select_kernel(req.pattern, req.omega,
                                                patterns)
            else:
                data, cnt = brtpf_select_with_cnt(self.store, req.pattern,
                                                  req.omega)
        else:
            self.counters.server_lookups += 1
            if self._selector is not None:
                data, cnt = self._select_kernel(req.pattern, None,
                                                [req.pattern])
            else:
                data = tpf_select(self.store, req.pattern)
                cnt = self.store.cardinality(req.pattern)
        _trace.phase("serve")
        self._memoize(memo_key, data, cnt)
        return data, cnt

    def _count_data(self, req: Request, memo_key) -> Tuple[np.ndarray, int]:
        """Count-probe evaluation (docs/fusion.md): Definition-2 ``cnt``
        with no materialized rows. Accelerated backends run their
        ``select_count`` cnt-only path (the bind-join grid still
        evaluates; the gather/stream epilogue is skipped); the numpy
        oracle uses ``brtpf_count`` (pure ``cardinality`` sums)."""
        omega = req.omega if req.is_brtpf else None
        patterns = instantiate_patterns(req.pattern, omega)
        self.counters.server_lookups += len(patterns)
        if self._selector is not None:
            n0 = len(self._selector.launches)
            cnt = self._selector.select_count(req.pattern, omega, patterns)
            _trace.phase("serve")
            self._charge_launches(self._selector.launches[n0:])
        elif omega is not None:
            from .selectors import brtpf_count
            cnt = brtpf_count(self.store, req.pattern, omega)
        else:
            cnt = int(self.store.cardinality(req.pattern))
        _trace.phase("serve")
        data = np.empty((0, 3), dtype=np.int32)
        self._memoize(memo_key, data, cnt)
        return data, cnt

    def _select_kernel(self, tp: TriplePattern,
                       omega: Optional[np.ndarray],
                       insts) -> Tuple[np.ndarray, int]:
        n0 = len(self._selector.launches)
        data, cnt = self._selector.select_with_cnt(tp, omega,
                                                          insts)
        _trace.phase("serve")
        self._charge_launches(self._selector.launches[n0:])
        return data, cnt

    def _charge_launches(self, launches, batched_requests: int = 0) -> None:
        for rec in launches:
            if rec.skipped:
                # a launch the selector avoided via the fragment store
                # (the selector already bumped fragments.launches_skipped)
                self.counters.launches_skipped += 1
                continue
            if rec.fast_path:
                # small-work decision: the groups were served by the
                # numpy block evaluation -- no kernel ran, so the launch
                # budget and the streamed-candidate totals must not be
                # charged (cand_streamed on the record documents the
                # decision quantity, not an HBM pass)
                self.counters.fast_path_selects += rec.groups
                continue
            self.counters.kernel_launches += 1
            self.counters.kernel_cand_streamed += rec.cand_streamed
            self.counters.kernel_cand_rows += (rec.cand_rows
                                               or rec.cand_streamed)
            self.counters.kernel_cand_full_rows += (
                rec.full_rows or rec.cand_rows or rec.cand_streamed)
            self.counters.kernel_pat_slots += rec.pat_slots
            if rec.segments > 1:
                # shape classification of the launch just charged above
                # (fused launches ARE kernel launches), feeding the
                # fused_segments_per_launch metric (docs/fusion.md)
                self.counters.fused_launches += 1
                self.counters.fused_segments += rec.segments
            if rec.pruned:
                # covers sub-window compaction too: a compacted record
                # has cand_full = window, cand_streamed = wc, so its
                # reclaimed_rows = window - wc is exactly this delta
                self.counters.cand_pruned_away += max(
                    rec.cand_full - rec.cand_streamed, 0)
        self.counters.kernel_batched_requests += batched_requests

    def _memoize(self, memo_key, data: np.ndarray, cnt: int) -> None:
        self.counters.server_triples_scanned += int(data.shape[0])
        # The unified store LRU-trims the data layer; when a pattern's
        # last live fragment goes, on_release evicts the store's
        # candidate range coherently (a pattern no fragment is streaming
        # has no reason to pin its materialized range either).
        self.fragments.put_data(memo_key, (data, cnt))

    def _paginate(self, data: np.ndarray, cnt: int, req: Request) -> Fragment:
        lo = req.page * self.page_size
        page = data[lo : lo + self.page_size]
        return Fragment(
            data=page,
            cnt=cnt,
            page=req.page,
            page_size=self.page_size,
            has_next=lo + self.page_size < data.shape[0],
            meta_triples=self.meta_triples_per_page,
        )

    # -- cross-request batching (kernel backend) -----------------------------

    def handle_batch(self, reqs: Sequence[Request]) -> List[Fragment]:
        """Serve a set of concurrent page requests as one unit.

        With an accelerated backend (kernel or sharded), brTPF/TPF
        requests for the *same* triple pattern whose selector results
        are not already available (memo or HTTP cache) are coalesced
        into one grouped launch sequence -- one shared pass over the
        pattern's candidate stream (the range bucket on the kernel
        path; each per-shard window on the sharded path) instead of one
        pass per request. Responses (and all paging / caching /
        transfer accounting) are identical to issuing the requests
        through :meth:`handle` one by one.

        The batch is atomic with respect to validation: an over-maxMpR
        member raises :class:`MaxMprExceeded` *before* any selector
        work runs, so no member's computed fragment is ever discarded.
        """
        for req in reqs:
            self.validate(req)
        if self._selector is None:
            return [self.handle(r) for r in reqs]
        # A batch may carry more distinct selections than the memo cap;
        # widen it for the batch's lifetime so prefilled results are
        # still there when handle() reads them, then trim back.
        cap = self.fragments.memo_capacity
        self.fragments.memo_capacity = cap + len(reqs)
        try:
            _trace.phase("prep")
            self._prefill_batch(reqs)
            _trace.phase("serve")
            return [self.handle(r) for r in reqs]
        finally:
            self._prefilled = set()
            self.fragments.memo_capacity = cap
            self.fragments.trim()

    def _prefill_batch(self, reqs: Sequence[Request]) -> None:
        groups: "OrderedDict" = OrderedDict()
        for req in reqs:
            if self.cache is not None and self.cache.contains(req.key()):
                continue  # served by the proxy, no origin work
            memo_key = req.key()[:2]
            if self.fragments.contains_data(memo_key):
                continue  # resident in the unified store, no launch
            per_pattern = groups.setdefault(
                (req.pattern.as_tuple(), req.count_only), OrderedDict())
            if memo_key not in per_pattern:
                per_pattern[memo_key] = req
        # Cross-pattern fusion (docs/fusion.md): >= 2 distinct
        # (pattern, count_only) groups become segments of fused launches
        # -- singleton groups ride along (they'd otherwise launch solo
        # through handle()). A homogeneous batch has nothing to fuse and
        # keeps the classic same-pattern grouped path below.
        if self.config.fuse_patterns and len(groups) >= 2:
            self._prefill_fused(groups)
            return
        for members in groups.values():
            member_reqs = list(members.values())
            if len(member_reqs) < 2:
                continue  # solo requests take the normal handle() path
            _trace.phase("prep")
            tp = member_reqs[0].pattern
            omegas = [r.omega if r.is_brtpf else None
                      for r in member_reqs]
            insts = [instantiate_patterns(tp, om) for om in omegas]
            n0 = len(self._selector.launches)
            results = self._selector.select_same_pattern(
                tp, omegas, insts)
            _trace.phase("serve")
            self._charge_launches(self._selector.launches[n0:],
                                  batched_requests=len(member_reqs))
            self._consume_prefill(member_reqs, insts, results)

    def _prefill_fused(self, groups: "OrderedDict") -> None:
        """Serve a heterogeneous batch's miss groups as fused segments."""
        from .kernel_selectors import FusedSegment
        segments = []
        members = []
        for (_ptuple, count_only), per in groups.items():
            member_reqs = list(per.values())
            tp = member_reqs[0].pattern
            omegas = [r.omega if r.is_brtpf else None
                      for r in member_reqs]
            insts = [instantiate_patterns(tp, om) for om in omegas]
            segments.append(FusedSegment(tp=tp, omegas=omegas,
                                         patterns=insts,
                                         count_only=count_only))
            members.append((member_reqs, insts))
        n0 = len(self._selector.launches)
        rows = self._selector.select_fused(segments)
        _trace.phase("serve")
        self._charge_launches(
            self._selector.launches[n0:],
            batched_requests=sum(len(m) for m, _ in members))
        for (member_reqs, insts), row in zip(members, rows, strict=True):
            self._consume_prefill(member_reqs, insts, row)

    def _consume_prefill(self, member_reqs, insts, results) -> None:
        for req, patterns, (data, cnt) in zip(member_reqs, insts,
                                              results, strict=True):
            self.counters.server_lookups += len(patterns)
            memo_key = req.key()[:2]
            self._memoize(memo_key, data, cnt)
            self._prefilled.add(memo_key)

    # -- convenience ---------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """Canonical metrics envelope: counters + per-layer cache
        accounting over the unified fragment store (metrics.py), the
        schema the JAX package serves at ``GET /metrics``."""
        return metrics_snapshot(self)

    def shard_launch_snapshot(self) -> np.ndarray:
        """Copy of the per-shard planned-window-page counters (sharded
        backend only; empty for the others) -- the delta surface the
        client's per-request trace record reads (docs/federation.md,
        "Placement")."""
        sel = self._selector
        if sel is not None and hasattr(sel, "shard_pages"):
            return np.array(sel.shard_pages, dtype=np.int64)
        return np.zeros((0,), dtype=np.int64)

    def cuda_work(self) -> CudaWork:
        """Copy of the accelerated selector's CUDA kernel work (launches
        and live slots; zeros on the numpy backend) -- the delta surface
        the client's per-request trace record reads for the simulator's
        charge (``sim.kernel_charge``)."""
        sel = self._selector
        return sel.cuda.snapshot() if sel is not None else CudaWork()

    def repartition(self, heat=None) -> None:
        """Workload-aware re-fragmentation cutover (docs/federation.md,
        "Placement").

        Plans a placement from the recorded heat (the server's own
        ``placement_policy="heat"`` log unless one is passed), rebuilds
        the :class:`~repro_torch.core.federation.FederatedStore` under
        the new boundaries + replica ranges, rebinds the selector, and
        clears the unified fragment store -- conservative cutover
        coherence: fragments are byte-identical across partitionings,
        but resident pages predate the new boundaries and serving them
        residency-free would hide the rebalance from the per-shard
        counters. The async front end wraps this under its flush lock
        (``AsyncBrTPFServer.repartition``) so the swap lands atomically
        between flushes.
        """
        if self.selector_backend != "sharded":
            raise RuntimeError("repartition requires the sharded backend")
        heat = heat if heat is not None else self._heat
        if heat is None or len(heat) == 0:
            raise ValueError(
                "no heat recorded: pass a HeatLog, or construct the "
                "server with placement_policy='heat'")
        self.federated = self.federated.repartition(heat)
        self._selector.rebind(self.federated)
        self.fragments.clear()

    def reset_counters(self) -> None:
        self.counters.reset()
        self.fragments.reset_counters()
        sel = self._selector
        if sel is not None and hasattr(sel, "reset_shard_counters"):
            sel.reset_shard_counters()
        self._range_base = (self.store.range_memo_hits,
                            self.store.range_memo_misses)
        if self.cache is not None:
            self.cache.hits = 0
            self.cache.misses = 0
