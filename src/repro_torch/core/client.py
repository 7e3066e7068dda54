"""Client-side query execution: the TPF client and the brTPF client.

``TPFClient`` follows the originally proposed TPF algorithm (Verborgh et
al. [19], paper section 4.2): recursively decompose the BGP, always
executing the (instantiated) triple pattern with the smallest result-size
estimate first; every intermediate solution re-instantiates the remaining
patterns and triggers fresh first-page requests for all of them. This is
where TPF's request explosion comes from.

``BrTPFClient`` follows paper section 4.3: a *deliberately simple* fixed
left-deep pipeline ordered by first-page cardinality estimates; each
iterator consumes chunks of at most ``maxMpR`` solution mappings, attaches
them to a brTPF request, and joins the returned triples with the chunk.

Both clients talk to the same :class:`~repro_torch.core.server.BrTPFServer`
through the same ``handle`` boundary so every metric is comparable.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from .bgp import BGP
from .fragments import ClientFragmentCache
from .rdf import (UNBOUND, TriplePattern, is_var, decode_var,
                  mapping_from_triple)
from .server import BrTPFServer, Request


class RequestBudgetExceeded(RuntimeError):
    """Raised when a query execution exceeds its request budget (the
    evaluation-harness analogue of the paper's 5-minute timeout)."""


@dataclasses.dataclass
class ExecutionResult:
    solutions: np.ndarray          # int32 [R, V]
    num_requests: int
    data_received: int
    timed_out: bool = False


class _ClientBase:
    """Shared client machinery.

    Includes a per-execution client-side HTTP cache (the Node.js
    ldf-client caches GET responses): the TPF algorithm re-requests the
    first page of every remaining (often identical, still-unbound)
    pattern at each recursion node, and without local caching those
    repeats would dominate #req/dataRecv and make them grow with page
    size -- which the paper's measurements rule out (section 5.3).
    The cache is cleared per execute() (the paper restarts the client
    process between query executions). Both the sync clients here and
    :class:`AsyncBrTPFClient` share one implementation --
    :class:`~repro_torch.core.fragments.ClientFragmentCache`, a page layer of
    the same :class:`~repro_torch.core.fragments.FragmentStore` class the
    server's unified cache is built on."""

    def __init__(self, server: BrTPFServer,
                 request_budget: Optional[int] = None,
                 tick: Optional[Callable[[str, int], None]] = None,
                 client_cache: bool = True) -> None:
        self.server = server
        self.request_budget = request_budget
        self._requests_used = 0
        self.client_cache = ClientFragmentCache(client_cache)
        # tick(kind, units) lets the throughput simulator charge time for
        # client-side work ("join") and network round trips ("request").
        self._tick = tick or (lambda kind, units: None)

    # -- HTTP boundary -------------------------------------------------------

    def _fetch(self, pattern: TriplePattern,
               omega: Optional[np.ndarray], page: int,
               count_only: bool = False):
        req = Request(pattern, omega, page, count_only)
        cached = self.client_cache.get(req.key())
        if cached is not None:
            return cached  # local hit: nothing on the wire
        if (self.request_budget is not None
                and self._requests_used >= self.request_budget):
            raise RequestBudgetExceeded()
        self._requests_used += 1
        if omega is not None:
            self.server.counters.mappings_sent += int(omega.shape[0])
        before = self.server.counters.snapshot()
        shard_snap = getattr(self.server, "shard_launch_snapshot", None)
        before_shards = shard_snap() if shard_snap is not None else None
        work = getattr(self.server, "cuda_work", None)
        before_work = work() if work is not None else None
        frag = self.server.handle(req)
        after = self.server.counters
        after_work = work() if work is not None else None
        # Structured per-request record: feeds the multi-client
        # throughput simulation (trace replay; see core/sim.py). The
        # kernel-launch geometry (candidates streamed / pattern slots)
        # lets the replay re-cost the request under cross-request
        # batching: same-pattern requests share one candidate stream.
        self._tick("http", {
            "key": req.key(),
            "lookups": after.server_lookups - before.server_lookups,
            "scanned": (after.server_triples_scanned
                        - before.server_triples_scanned),
            "recv": frag.triples_received,
            "pattern_key": pattern.as_tuple(),
            "cand": (after.kernel_cand_streamed
                     - before.kernel_cand_streamed),
            "cand_rows": (after.kernel_cand_rows
                          - before.kernel_cand_rows),
            "cand_full_rows": (after.kernel_cand_full_rows
                               - before.kernel_cand_full_rows),
            "pats": after.kernel_pat_slots - before.kernel_pat_slots,
            "launches": (after.kernel_launches
                         - before.kernel_launches),
            # per-shard planned-page delta (sharded backend; empty
            # otherwise) -- feeds the sim's shard-heat model
            "shard_pages": (
                tuple((shard_snap() - before_shards).astype(int).tolist())
                if before_shards is not None and before_shards.size
                else ()),
            # what the CUDA kernels did for this request (the port's
            # own): launches, one per grouped or fused chunk, and the
            # live pattern slots of its LaunchRecords
            "cuda_launches": (after_work.launches - before_work.launches
                              if work is not None else 0),
            "live_slots": (after_work.live_slots - before_work.live_slots
                           if work is not None else 0),
        })
        self.client_cache.put(req.key(), frag)
        return frag

    def _fetch_all_pages(self, pattern: TriplePattern,
                         omega: Optional[np.ndarray] = None,
                         first: Optional[object] = None) -> np.ndarray:
        """Fetch every page of a fragment; ``first`` may be a pre-fetched
        page-0 fragment (cardinality probe reuse)."""
        pages: List[np.ndarray] = []
        page = 0
        frag = first
        if frag is None:
            frag = self._fetch(pattern, omega, 0)
        pages.append(frag.data)
        while frag.has_next:
            page += 1
            frag = self._fetch(pattern, omega, page)
            pages.append(frag.data)
        if len(pages) == 1:
            return pages[0]
        return np.concatenate(pages, axis=0)


# ---------------------------------------------------------------------------
# TPF client (Verborgh et al. algorithm)
# ---------------------------------------------------------------------------


class TPFClient(_ClientBase):
    def execute(self, bgp: BGP) -> ExecutionResult:
        self._requests_used = 0
        self.client_cache.clear()
        base = self.server.counters.snapshot()
        timed_out = False
        acc: List[np.ndarray] = []
        root = np.full((bgp.num_vars,), UNBOUND, dtype=np.int32)
        try:
            self._recurse(list(bgp.patterns), root, bgp.num_vars, acc)
        except RequestBudgetExceeded:
            timed_out = True
        if acc:
            sols = np.unique(np.stack(acc).astype(np.int32), axis=0)
        else:
            sols = np.empty((0, bgp.num_vars), dtype=np.int32)
        snap = self.server.counters
        return ExecutionResult(
            solutions=sols,
            num_requests=snap.num_requests - base.num_requests,
            data_received=snap.data_received - base.data_received,
            timed_out=timed_out,
        )

    def _recurse(self, patterns: List[TriplePattern], mu: np.ndarray,
                 num_vars: int, acc: List[np.ndarray]) -> None:
        if not patterns:
            acc.append(mu)
            return
        # Probe page 0 of every remaining (instantiated) pattern to get
        # fresh cardinality estimates -- one request each, per [19].
        insts = [tp.instantiate(mu) for tp in patterns]
        frags = []
        for inst in insts:
            frag = self._fetch(inst, None, 0)
            frags.append(frag)
            if frag.cnt == 0:
                return  # some pattern cannot match: prune this branch
        best = min(range(len(insts)), key=lambda i: frags[i].cnt)
        rest = patterns[:best] + patterns[best + 1:]
        triples = self._fetch_all_pages(insts[best], None, frags[best])
        self._tick("join", int(triples.shape[0]))
        for t in triples:
            m = mapping_from_triple(insts[best], t, num_vars)
            if m is None:
                continue
            merged = mu.copy()
            bind = (merged == UNBOUND) & (m != UNBOUND)
            merged[bind] = m[bind]
            self._recurse(rest, merged, num_vars, acc)


def plan_join_order(bgp: BGP, cnts: Sequence[int]) -> List[int]:
    """Fixed left-deep join order (paper section 4.3): smallest first-page
    cardinality estimate first, then greedily the cheapest pattern
    *connected* to the already-bound variables (a bind join against a
    pattern sharing no variable restricts nothing). Shared by the sync
    and async brTPF clients."""
    remaining = set(range(len(bgp)))
    first = min(remaining, key=lambda i: (cnts[i], i))
    order = [first]
    remaining.discard(first)
    bound = set(bgp.patterns[first].variables())
    while remaining:
        connected = [i for i in remaining
                     if bound & set(bgp.patterns[i].variables())]
        pool = connected or sorted(remaining)
        nxt = min(pool, key=lambda i: (cnts[i], i))
        order.append(nxt)
        remaining.discard(nxt)
        bound |= set(bgp.patterns[nxt].variables())
    return order


# ---------------------------------------------------------------------------
# brTPF client (paper section 4.3)
# ---------------------------------------------------------------------------


class BrTPFClient(_ClientBase):
    """``count_probes=True`` issues the upfront cardinality probes as
    count-only requests (docs/fusion.md): the server answers with the
    Definition-2 ``cnt`` and an empty data page, never materializing
    (or shipping) rows the planner only needed an estimate from. The
    most selective pattern's first data page is then fetched normally
    (the classic probe doubles as page 0; a count probe cannot)."""

    def __init__(self, server: BrTPFServer, max_mpr: Optional[int] = None,
                 request_budget: Optional[int] = None,
                 tick=None, count_probes: bool = False) -> None:
        super().__init__(server, request_budget, tick)
        self.max_mpr = max_mpr if max_mpr is not None else server.max_mpr
        self.count_probes = bool(count_probes)

    def execute(self, bgp: BGP) -> ExecutionResult:
        self._requests_used = 0
        self.client_cache.clear()
        base = self.server.counters.snapshot()
        timed_out = False
        sols = np.empty((0, bgp.num_vars), dtype=np.int32)
        try:
            sols = self._run_pipeline(bgp)
        except RequestBudgetExceeded:
            timed_out = True
        snap = self.server.counters
        return ExecutionResult(
            solutions=sols,
            num_requests=snap.num_requests - base.num_requests,
            data_received=snap.data_received - base.data_received,
            timed_out=timed_out,
        )

    # -- fixed left-deep plan ------------------------------------------------

    def _run_pipeline(self, bgp: BGP) -> np.ndarray:
        nv = bgp.num_vars
        # Upfront plan: first TPF page of each pattern -> cnt estimates
        # ("These estimates can be obtained from the server by requesting
        # the first TPF page for each of the triple patterns", sec 4.3).
        # Left-deep join order: smallest-cardinality first, then greedily
        # the cheapest pattern *connected* to the already-bound variables
        # (avoiding cartesian products -- a bind join against a pattern
        # sharing no variable restricts nothing).
        probes = [self._fetch(tp, None, 0, count_only=self.count_probes)
                  for tp in bgp.patterns]
        if min(p.cnt for p in probes) == 0:
            return np.empty((0, nv), dtype=np.int32)
        order = plan_join_order(bgp, [p.cnt for p in probes])

        # Iterator 1: plain TPF over the most selective pattern. A count
        # probe carries no data page to reuse as page 0.
        first_idx = order[0]
        first_tp = bgp.patterns[first_idx]
        first_frag = None if self.count_probes else probes[first_idx]
        triples = self._fetch_all_pages(first_tp, None, first_frag)
        solutions = _mappings_from_matches(first_tp, triples, nv)
        self._tick("join", int(triples.shape[0]))

        # Iterators 2..n: bind-join via brTPF requests in maxMpR chunks.
        for idx in order[1:]:
            tp = bgp.patterns[idx]
            if solutions.shape[0] == 0:
                return solutions
            next_rounds: List[np.ndarray] = []
            for lo in range(0, solutions.shape[0], self.max_mpr):
                chunk = solutions[lo : lo + self.max_mpr]
                data = self._fetch_all_pages(tp, chunk)
                joined = _bind_join(tp, data, chunk, nv)
                self._tick("join", int(data.shape[0]) * 1)
                if joined.shape[0]:
                    next_rounds.append(joined)
            solutions = (np.concatenate(next_rounds, axis=0)
                         if next_rounds
                         else np.empty((0, nv), dtype=np.int32))
        return np.unique(solutions, axis=0) if solutions.shape[0] \
            else solutions


# ---------------------------------------------------------------------------
# Async brTPF client (concurrent BGP driver over the batching front end)
# ---------------------------------------------------------------------------


class AsyncBrTPFClient:
    """Concurrent BGP driver for :class:`~repro_torch.core.batching.AsyncBrTPFServer`.

    Runs the same fixed left-deep plan as :class:`BrTPFClient`
    (``plan_join_order``), but issues the independent pieces of each
    stage concurrently: the upfront cardinality probes go out together,
    and at every bind-join iterator the per-``maxMpR``-chunk page
    sequences are *all in flight at once* (each chunk still pages
    sequentially -- page ``n+1`` depends on page ``n``'s ``has_next``).
    Same-pattern chunk requests therefore land inside one batching
    window and coalesce into grouped kernel launches on the server --
    the client-visible results are identical to the sequential client's
    (both end in ``np.unique``; chunk arrival order doesn't matter).
    """

    def __init__(self, front, max_mpr: Optional[int] = None,
                 request_budget: Optional[int] = None,
                 client_cache: bool = True,
                 count_probes: bool = False,
                 deadline_ms: Optional[float] = None) -> None:
        # ``front`` is anything with ``async handle(Request) -> Fragment``
        # and a ``max_mpr`` bound, such as an AsyncBrTPFServer. Only an
        # in-process front end exposes the origin server itself.
        self.front = front
        self.server: Optional[BrTPFServer] = getattr(front, "server", None)
        if max_mpr is None:
            max_mpr = getattr(front, "max_mpr", None)
        if max_mpr is None:
            raise ValueError("front exposes no max_mpr; pass max_mpr=")
        self.max_mpr = max_mpr
        self.request_budget = request_budget
        self._requests_used = 0
        self._received = 0
        self.client_cache = ClientFragmentCache(client_cache)
        # count-only cardinality probes (docs/fusion.md): with a
        # heterogeneous BGP the concurrent probes land in one batching
        # window and fuse into cnt-only segments of one launch.
        self.count_probes = bool(count_probes)
        # Per-request deadline budget (docs/resilience.md), stamped onto
        # every outgoing Request as ``timeout_ms``. A ResilientTransport
        # below decrements it across retry attempts; a bare transport
        # simply bounds its await on it. None = unbounded (earlier
        # behavior, byte-identical wire bodies).
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 (or None)")
        self.deadline_ms = deadline_ms

    # -- HTTP boundary (async) ----------------------------------------------

    async def _fetch(self, pattern: TriplePattern,
                     omega: Optional[np.ndarray], page: int,
                     count_only: bool = False):
        req = Request(pattern, omega, page, count_only,
                      timeout_ms=self.deadline_ms)
        cached = self.client_cache.get(req.key())
        if cached is not None:
            return cached
        if (self.request_budget is not None
                and self._requests_used >= self.request_budget):
            raise RequestBudgetExceeded()
        self._requests_used += 1
        # In-process accounting only: a front end that exposes no
        # origin server charges mappings_sent at its own boundary.
        if omega is not None and self.server is not None:
            self.server.counters.mappings_sent += int(omega.shape[0])
        frag = await self.front.handle(req)
        self._received += frag.triples_received
        self.client_cache.put(req.key(), frag)
        return frag

    async def _fetch_all_pages(self, pattern: TriplePattern,
                               omega: Optional[np.ndarray] = None,
                               first: Optional[object] = None) -> np.ndarray:
        pages: List[np.ndarray] = []
        page = 0
        frag = first
        if frag is None:
            frag = await self._fetch(pattern, omega, 0)
        pages.append(frag.data)
        while frag.has_next:
            page += 1
            frag = await self._fetch(pattern, omega, page)
            pages.append(frag.data)
        if len(pages) == 1:
            return pages[0]
        return np.concatenate(pages, axis=0)

    # -- execution ----------------------------------------------------------

    async def execute(self, bgp: BGP) -> ExecutionResult:
        # Accounting is client-local (requests issued / triples received
        # by THIS client): with N concurrent clients on one server,
        # server-counter deltas would attribute everyone's traffic to
        # everyone.
        self._requests_used = 0
        self._received = 0
        self.client_cache.clear()
        timed_out = False
        sols = np.empty((0, bgp.num_vars), dtype=np.int32)
        try:
            sols = await self._run_pipeline(bgp)
        except RequestBudgetExceeded:
            timed_out = True
        return ExecutionResult(
            solutions=sols,
            num_requests=self._requests_used,
            data_received=self._received,
            timed_out=timed_out,
        )

    async def run_workload(self, workload) -> List[ExecutionResult]:
        """Execute a (name, BGP) sequence; the unit the concurrency
        benchmarks hand to each simulated client."""
        return [await self.execute(bgp) for _name, bgp in workload]

    @staticmethod
    async def _gather(coros):
        """asyncio.gather that cancels (and drains) siblings when one
        coroutine raises -- a budget-exhausted query must not leave
        orphan fetches running into the next query's accounting."""
        tasks = [asyncio.ensure_future(c) for c in coros]
        try:
            return await asyncio.gather(*tasks)
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise

    async def _run_pipeline(self, bgp: BGP) -> np.ndarray:
        nv = bgp.num_vars
        probes = await self._gather(
            [self._fetch(tp, None, 0, count_only=self.count_probes)
             for tp in bgp.patterns])
        if min(p.cnt for p in probes) == 0:
            return np.empty((0, nv), dtype=np.int32)
        order = plan_join_order(bgp, [p.cnt for p in probes])

        first_idx = order[0]
        first_tp = bgp.patterns[first_idx]
        first_frag = None if self.count_probes else probes[first_idx]
        triples = await self._fetch_all_pages(first_tp, None, first_frag)
        solutions = _mappings_from_matches(first_tp, triples, nv)

        for idx in order[1:]:
            tp = bgp.patterns[idx]
            if solutions.shape[0] == 0:
                return solutions
            chunks = [solutions[lo : lo + self.max_mpr]
                      for lo in range(0, solutions.shape[0], self.max_mpr)]
            # Independent omega chunks in flight together: same pattern,
            # same batching window -> one grouped launch server-side.
            datas = await self._gather(
                [self._fetch_all_pages(tp, chunk) for chunk in chunks])
            next_rounds = [joined
                           for chunk, data in zip(chunks, datas,
                                                  strict=True)
                           for joined in [_bind_join(tp, data, chunk, nv)]
                           if joined.shape[0]]
            solutions = (np.concatenate(next_rounds, axis=0)
                         if next_rounds
                         else np.empty((0, nv), dtype=np.int32))
        return np.unique(solutions, axis=0) if solutions.shape[0] \
            else solutions


# ---------------------------------------------------------------------------
# Vectorized join helpers (shared with the reference oracle / kernels)
# ---------------------------------------------------------------------------


def _mappings_from_matches(tp: TriplePattern, triples: np.ndarray,
                           num_vars: int) -> np.ndarray:
    """Convert matching triples into solution mappings, vectorized."""
    n = triples.shape[0]
    out = np.full((n, num_vars), UNBOUND, dtype=np.int32)
    ok = np.ones((n,), dtype=bool)
    comps = tp.as_tuple()
    for pos, c in enumerate(comps):
        if is_var(c):
            v = decode_var(c)
            prev_bound = out[:, v] != UNBOUND
            ok &= ~prev_bound | (out[:, v] == triples[:, pos])
            out[:, v] = triples[:, pos]
        else:
            ok &= triples[:, pos] == c
    return out[ok]


def _bind_join(tp: TriplePattern, triples: np.ndarray, omega: np.ndarray,
               num_vars: int) -> np.ndarray:
    """Join fragment triples with the chunk of mappings they were
    restricted by: for every (t, mu') with mu_t ~ mu', emit mu_t + mu'."""
    mu_t = _mappings_from_matches(tp, triples, num_vars)
    t_n, m_n = mu_t.shape[0], omega.shape[0]
    if t_n == 0 or m_n == 0:
        return np.empty((0, num_vars), dtype=np.int32)
    a = mu_t[:, None, :]          # [T, 1, V]
    b = omega[None, :, :]         # [1, M, V]
    both = (a != UNBOUND) & (b != UNBOUND)
    comp = np.all(~both | (a == b), axis=-1)          # [T, M]
    ti, mi = np.nonzero(comp)
    merged = mu_t[ti]
    take = (merged == UNBOUND) & (omega[mi] != UNBOUND)
    merged[take] = omega[mi][take]
    return merged
