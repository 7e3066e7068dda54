"""Multi-client throughput simulation (paper sections 6 and 7.2); the
port of ``repro.core.sim``.

The paper drives one server with up to 64 concurrent clients on a 17-
machine cluster. Raw wall-clock concurrency on one host cannot stand in
for that, so this module uses *trace replay*: every query
is executed once, for real, through the actual server/client code, and
the per-request records (server work, bytes returned, client join work)
are replayed through a discrete-event queueing model of the cluster:

  client --(latency/2)--> [server: k workers, FIFO] --(latency/2 +
       bytes/bandwidth)--> client-side join work --> next request

The optional shared HTTP cache (section 7.2) is replayed *inside* the
simulation -- hits depend on the global interleaving of all clients'
requests, exactly like the paper's nginx proxy. Service-time constants
are calibrated by timing the real engine on this machine
(``calibrate()``), so the simulated seconds are grounded in measured
per-triple and per-request costs. The kernel backend's launch, cell and
stream costs are those of the grouped CUDA kernel on an H100
(``calibrate_kernels()``); the JAX package's TPU projection is not
carried over.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bgp import BGP
from .cache import LRUCache
from .client import BrTPFClient, TPFClient
from .config import ServerConfig
from .server import BrTPFServer


# ---------------------------------------------------------------------------
# Trace collection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HttpRecord:
    key: tuple
    lookups: int
    scanned: int
    recv: int
    # kernel-backend launch geometry (zero for numpy-backend traces):
    # ``cand`` padded candidates streamed (summed over this request's
    # launches; on the sharded backend each launch streams one per-shard
    # window, so cand = launches * window), ``pats`` padded pattern
    # slots of this request's launch share, ``launches`` how many kernel
    # launches the request triggered (1 on the single-host kernel path;
    # the per-shard window-page count on the sharded path);
    # ``pattern_key`` identifies requests that can share one candidate
    # stream under cross-request batching.
    pattern_key: tuple = ()
    cand: int = 0
    pats: int = 0
    launches: int = 0
    # raw (pre-padding) candidate rows behind ``cand``: the fused-launch
    # model re-pads these at FUSED_BT tile granularity, which is how the
    # real fused stream is laid out (solo launches pad to a pow2 shape
    # bucket instead). 0 on old traces -> fall back to ``cand``.
    cand_rows: int = 0
    # raw full-range rows: when a batch's combined sub-range union
    # reaches this, pruning stops paying and the launch streams the full
    # range -- the cap on the model's additive union estimate.
    cand_full_rows: int = 0
    # per-shard planned-window-page delta (sharded backend only; empty
    # tuple otherwise / on old traces): the shard-heat model replays it
    # so --live can validate per-shard launch counts after a
    # workload-aware repartition (docs/federation.md, "Placement").
    shard_pages: tuple = ()


@dataclasses.dataclass
class QueryTrace:
    """Ordered per-query event list: HttpRecord | ('join', units)."""
    name: str
    events: List[object]
    completed: bool   # completed during trace collection (budget not hit)


class _Recorder:
    def __init__(self) -> None:
        self.events: List[object] = []

    def __call__(self, kind: str, payload) -> None:
        if kind == "http":
            self.events.append(HttpRecord(**payload))
        elif kind == "join":
            self.events.append(("join", int(payload)))


def collect_traces(server: BrTPFServer, workload: Sequence[Tuple[str, BGP]],
                   client_kind: str, max_mpr: Optional[int] = None,
                   request_budget: int = 20000) -> List[QueryTrace]:
    """Execute the workload once through the real engine, recording
    per-request traces. ``client_kind``: 'tpf' | 'brtpf'."""
    traces: List[QueryTrace] = []
    for name, bgp in workload:
        rec = _Recorder()
        if client_kind == "tpf":
            client = TPFClient(server, request_budget=request_budget,
                               tick=rec)
        else:
            client = BrTPFClient(server, max_mpr=max_mpr,
                                 request_budget=request_budget, tick=rec)
        res = client.execute(bgp)
        traces.append(QueryTrace(name, rec.events, not res.timed_out))
    return traces


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

# fused stream tile size -- mirrors DEFAULT_FUSED_BT in kernels/ops.py:
# a fused launch's candidate stream is laid out in bt-row tiles (one
# segment per tile) and padded to a power-of-two tile count.
_FUSED_BT = 256


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class SimParams:
    server_workers: int = 4            # paper: 4-core server machine
    req_overhead_s: float = 1.0e-3     # servlet + HTTP handling per request
    lookup_s: float = 2.0e-4           # per instantiated-pattern index probe
    scan_s_per_triple: float = 1.5e-6  # serialization + backend scan
    cache_hit_s: float = 2.0e-4        # nginx hit service time
    client_overhead_s: float = 2.0e-4  # per-request client bookkeeping
    join_s_per_triple: float = 4.0e-6  # client-side hash-join per triple
    net_latency_s: float = 1.0e-3      # one-way LAN latency
    bytes_per_triple: float = 120.0    # serialized triple size
    bandwidth_bps: float = 10e9 / 8    # 10 GbE
    timeout_s: float = 300.0           # the paper's 5-minute timeout
    duration_s: float = 3600.0         # measure throughput over one hour
    # both paper clients issue HTTP requests asynchronously in parallel
    # (section 6.3); latency/client overhead amortize over the window
    pipeline_depth: int = 8
    max_events: int = 4_000_000        # replay safety valve
    # -- kernel selector backend (the grouped CUDA kernel) -----------------
    # Used for requests whose trace carries launch geometry (cand > 0).
    # Defaults are what calibrate_kernels() measured in one run of
    # chip_smoke.py's phase 8 on an NVIDIA H100 80GB HBM3, power limit
    # 700.00 W: the host wall time of a one-page launch through to its
    # completion, and the device time per (row, live slot) cell and per
    # streamed row at the chunk cap. The replay keeps the JAX package's
    # accounting, which counts other quantities than the CUDA kernel
    # runs: it charges a cell per padded pattern slot (``pats``, 128 a
    # launch) where the kernel loops over the live ones only, and a
    # launch overhead per ``launches`` entry, which on the sharded
    # backend is one per window page where one CUDA launch serves a
    # whole chunk of pages. Both overstate the kernel's time.
    kernel_launch_overhead_s: float = 4.7306e-05
    kernel_cell_s: float = 6.9297e-13    # per compare-grid cell
    kernel_stream_s: float = 1.3413e-11  # per candidate triple streamed
    # > 0 enables server-side cross-request batching: same-pattern
    # requests arriving while a launch is still queued share its
    # candidate stream and pay only their marginal pattern-slot cells.
    batch_window_s: float = 0.0
    # cross-pattern kernel fusion (docs/fusion.md): with batching on, a
    # request whose pattern DIFFERS from the open launch's still joins
    # it -- as a new fused segment that brings its own candidate stream
    # (same-pattern joiners share an existing segment's stream and add
    # none). Caps mirror ``fusion_legality`` in core/kernel_selectors.py:
    # a launch refuses new segments past the segment/stream ceilings.
    fuse_patterns: bool = True
    fused_max_segments: int = 16      # MAX_FUSED_SEGMENTS
    fused_max_stream: int = 131072    # MAX_FUSED_STREAM (candidate rows)
    # unified fragment store (core/fragments.py): a kernel-path request
    # whose fragment was computed by an EARLIER request (and whose
    # launch is no longer joinable) skips its launch entirely -- it is
    # served from the memo at servlet overhead. Mirrors the real
    # server's memo-capacity LRU.
    selector_memo_entries: int = 256


def calibrate(server: BrTPFServer, workload, reps: int = 3) -> SimParams:
    """Ground the cost model in measured engine timings on this host."""
    from .rdf import TriplePattern, encode_var
    store = server.store
    v = encode_var
    # time a representative scan-heavy pattern
    tp = TriplePattern(v(0), v(1), v(2))
    t0 = time.perf_counter()
    n = 0
    for _ in range(reps):
        n += store.match(tp).shape[0]
    scan_s = (time.perf_counter() - t0) / max(n, 1)
    # time index probes (fully bound patterns)
    probe = TriplePattern(1, 2, 3)
    t0 = time.perf_counter()
    for _ in range(200):
        store.cardinality(probe)
    lookup_s = (time.perf_counter() - t0) / 200
    p = SimParams()
    p.scan_s_per_triple = max(scan_s, 1e-8)
    p.lookup_s = max(lookup_s, 1e-7)
    p.join_s_per_triple = 2.5 * p.scan_s_per_triple  # joins touch each
    return p                                         # triple a few times


def calibrate_kernels(device: Optional[str] = None) -> Dict[str, float]:
    """The kernel backend's cost profile, timed on the card: the
    :class:`SimParams` fields ``kernel_launch_overhead_s``,
    ``kernel_cell_s`` and ``kernel_stream_s``.

    Times the grouped CUDA bind-join kernel (``bindjoin_grouped_cuda``)
    over rows that all pass its base-pattern prologue:

    * one page of 1024 rows, one group, one live slot: the host wall time
      of a launch through to its completion (``synchronize``), the fixed
      cost a launch adds whatever its size;
    * the chunk cap (``federation.MAX_CHUNK_ROWS``: 1024 pages x 4 shards
      x 1024 rows) with one live slot and with maxMpR = 30 live slots,
      device time from CUDA events, each launch on rows not in L2: the
      difference over 29 extra cells per row is the cost of a (row, live
      slot) cell, and what the one-slot launch takes beyond its cells is
      the cost of a streamed row.

    ``device=None`` means CUDA, as for every entry point; it raises
    without a CUDA device, and for any other device (the plain versions'
    times would say nothing about the card).
    """
    import torch

    from ..kernels.bindjoin import bindjoin_grouped_cuda
    from ..kernels.ops import resolve_device
    from .federation import MAX_CHUNK_ROWS
    from .server import DEFAULT_MAX_MPR

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("calibrate_kernels times the CUDA kernel; it "
                           f"needs a CUDA device, not {dev}")
    reps = 20
    gen = torch.Generator(device=dev).manual_seed(0)
    shards, width, mp = 4, 1024, 128
    pages = MAX_CHUNK_ROWS // (shards * width)
    n = pages * width

    def ints(hi, size):
        return torch.randint(0, hi, size, generator=gen, device=dev,
                             dtype=torch.int32)

    # every row has the base pattern's predicate, so every row passes
    # the prologue and meets each live slot
    triples = torch.stack([ints(64, (shards, n)),
                           torch.full((shards, n), 7, dtype=torch.int32,
                                      device=dev),
                           ints(64, (shards, n))], dim=-1).contiguous()
    base = torch.tensor([-1, 7, -1, 0, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)

    def launch(p, s, live):
        slots = torch.zeros((1, mp, 4), dtype=torch.int32, device=dev)
        slots[0, :live, 0] = ints(64, (live,))
        slots[0, :live, 1] = 7
        slots[0, :live, 2] = -1
        slots[0, :live, 3] = 1
        lo = torch.arange(p, device=dev, dtype=torch.int64)[:, None] * width
        spans = torch.stack([lo.expand(p, s), (lo + width).expand(p, s)],
                            dim=-1).contiguous()
        sub = triples[:s].contiguous()
        return lambda: bindjoin_grouped_cuda(sub, None, slots, base,
                                             spans=spans, width=width,
                                             live=live)

    # Before each timed launch the card writes 4 x 256 MiB: the rows are
    # read cold (not from the 50 MB L2), and the card is still busy when
    # the host has issued the launch, so the events time the kernel and
    # not the host's issuing of it.
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def device_s(fn):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            for _ in range(4):
                flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / 1e3 / reps

    def host_s(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    rows = pages * shards * width
    overhead = host_s(launch(1, 1, 1))
    one = device_s(launch(pages, shards, 1))
    full = device_s(launch(pages, shards, DEFAULT_MAX_MPR))
    cell = max(full - one, 0.0) / (rows * (DEFAULT_MAX_MPR - 1))
    stream = max(one / rows - cell, 0.0)
    return {"kernel_launch_overhead_s": overhead, "kernel_cell_s": cell,
            "kernel_stream_s": stream}


# ---------------------------------------------------------------------------
# Discrete-event replay
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    completed: int
    timeouts: int
    attempted: int
    qet_sum: float            # total QET of completed queries
    qets: List[float]
    simulated_s: float = 3600.0   # horizon actually replayed
    # kernel-backend replay only: launches *created* (a request joining
    # an open same-pattern launch inside the batching window does not
    # create one) and kernel-path requests replayed -- the pair the live
    # validation loop (``live_replay``) checks against the real front end.
    launches: int = 0
    kernel_requests: int = 0
    # launches avoided because the request's fragment was resident in
    # the modeled unified store (memo or shared HTTP cache) -- the
    # third quantity live_replay validates.
    launches_skipped: int = 0
    # cross-pattern fusion shape (mirrors Counters.fused_launches /
    # fused_segments): launches that ended up serving >= 2 distinct
    # pattern keys, and the total distinct keys across those launches.
    fused_launches: int = 0
    fused_segments: int = 0
    # candidate rows streamed by created launches (requests that join an
    # open launch share its stream and add none; skipped requests stream
    # nothing). Traces collected against a pruning server already carry
    # the pruned per-request stream in ``HttpRecord.cand``, so this is
    # the model's Omega-restricted streaming total -- the fourth
    # quantity live_replay validates.
    cand_streamed: int = 0
    # raw (pre-padding) candidate rows behind cand_streamed. Additive
    # across requests, so -- unlike the padded total, whose pow2/tile
    # padding depends on how requests regrouped into launches -- this is
    # invariant under batching composition and is the tighter live
    # validation quantity.
    cand_rows: int = 0
    # per-shard planned-window-page totals accumulated from created
    # launches' HttpRecord.shard_pages deltas (sharded traces only;
    # empty otherwise) -- the shard-heat model --live validates per
    # shard (docs/federation.md, "Placement").
    shard_launches: tuple = ()

    @property
    def launches_per_request(self) -> float:
        return self.launches / max(self.kernel_requests, 1)

    @property
    def cand_per_request(self) -> float:
        return self.cand_streamed / max(self.kernel_requests, 1)

    @property
    def skips_per_request(self) -> float:
        return self.launches_skipped / max(self.kernel_requests, 1)

    @property
    def fused_segments_per_launch(self) -> float:
        return self.fused_segments / max(self.fused_launches, 1)

    @property
    def throughput_per_hour(self) -> float:
        return self.completed * 3600.0 / max(self.simulated_s, 1e-9)

    @property
    def attempts_per_hour(self) -> float:
        return self.attempted * 3600.0 / max(self.simulated_s, 1e-9)

    @property
    def avg_qet(self) -> float:
        return self.qet_sum / self.completed if self.completed else 0.0


@dataclasses.dataclass
class _Launch:
    """One (possibly grouped, possibly fused) launch queued on a worker."""

    key: tuple
    start: float                 # when it begins executing (no more joins)
    done: float                  # completion; grows as requests join
    worker: int
    waiters: List[tuple] = dataclasses.field(default_factory=list)
    # fused-segment bookkeeping: raw candidate rows per pattern key
    # (same-key joiners extend their segment's sub-range union --
    # bind-join chunks are disjoint, so union ~ sum) and the creator's
    # solo padded stream (the floor when the launch never fuses: a
    # singleton launch pads to the solo shape bucket).
    seg_rows: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    # per-key full-range row cap: members' combined sub-range unions
    # cannot exceed the pattern's range, and once they reach it the real
    # launch streams the (unpruned) full range instead
    seg_full: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    solo_cand: int = 0
    # fragment identities already being computed by this launch: a
    # same-fragment duplicate arriving in the same window is served from
    # the batch prefill's memo (a store skip), never a new group
    frags: set = dataclasses.field(default_factory=set)

    @property
    def keys(self):
        return self.seg_rows.keys()

    def seg_streamed(self) -> List[int]:
        """Per-segment raw rows actually streamed (union capped at full)."""
        return [min(r, self.seg_full.get(k)) if self.seg_full.get(k)
                else r for k, r in self.seg_rows.items()]

    def stream_tiles(self) -> int:
        """FUSED_BT-aligned tile count of the fused candidate stream."""
        return sum(-(-max(r, 1) // _FUSED_BT)
                   for r in self.seg_streamed())


class _Server:
    """k identical workers + FIFO queue (+ optional launch batching)."""

    def __init__(self, workers: int, batch_window: float = 0.0,
                 fuse: bool = False, max_segments: int = 16,
                 max_stream: int = 131072) -> None:
        self.free_at = [0.0] * workers
        self.batch_window = batch_window
        self.fuse = fuse
        self.max_segments = max_segments
        self.max_stream = max_stream
        # pattern_key -> newest still-queued launch for that pattern
        # (unfused batching); under fusion the newest launch is joinable
        # by ANY pattern, so one global slot suffices.
        self._open: Dict[tuple, _Launch] = {}
        self._open_any: Optional[_Launch] = None

    def schedule(self, arrival: float, service: float) -> float:
        """Returns completion time; assigns the earliest-free worker."""
        i = int(np.argmin(self.free_at))
        start = max(arrival, self.free_at[i])
        done = start + service
        self.free_at[i] = done
        return done

    def schedule_launch(self, arrival: float, key: tuple, overhead: float,
                        stream: float, marginal: float,
                        cand_rows: int = 0, solo_cand: int = 0,
                        frag_key: tuple = (), full_rows: int = 0,
                        ) -> Tuple[_Launch, bool, bool, bool]:
        """Schedule one kernel launch, batching/fusing where possible.

        ``overhead`` is the per-launch dispatch cost, ``stream`` the
        cost of this request's candidate HBM stream, ``marginal`` its
        own pattern-slot compare cells. A request arriving before an
        earlier launch *starts* joins it (``batch_window`` > 0 delays
        each start to give concurrent requests time to coalesce):

        * same ``key`` -- it shares that segment's candidate stream and
          the launch grows by ``marginal`` only (one padded grouped
          launch, ``BrTPFServer.handle_batch``);
        * different ``key`` under fusion -- it becomes a NEW segment of
          the fused launch (``select_fused``): the launch grows by
          ``stream + marginal`` because the segment brings its own
          candidate block, but pays no extra dispatch overhead. The
          launch refuses segments past the ``fusion_legality`` caps.

        Every member completes together at the launch's final ``done``.
        Returns (launch, created, new_segment, duplicate) --
        ``new_segment`` is True when this request added its own
        candidate stream (always True for a created launch);
        ``duplicate`` marks a same-fragment repeat served from the batch
        prefill's memo (a store skip on the live server, no new work).
        """
        tiles = -(-max(cand_rows, 1) // _FUSED_BT)
        if self.batch_window > 0.0:
            open_ = self._open_any if self.fuse else self._open.get(key)
            if open_ is not None and arrival <= open_.start:
                if frag_key and frag_key in open_.frags:
                    return open_, False, False, True
                if key in open_.keys:
                    grow, new_seg = marginal, False
                    open_.seg_rows[key] += max(cand_rows, 0)
                    open_.seg_full[key] = max(open_.seg_full.get(key, 0),
                                              full_rows)
                    open_.frags.add(frag_key)
                elif (self.fuse
                        and len(open_.keys) < self.max_segments
                        and (open_.stream_tiles() + tiles) * _FUSED_BT
                        <= self.max_stream):
                    grow, new_seg = stream + marginal, True
                    open_.seg_rows[key] = max(cand_rows, 0)
                    open_.seg_full[key] = full_rows
                    open_.frags.add(frag_key)
                else:
                    open_ = None   # fusion caps reached: fresh launch
                if open_ is not None:
                    open_.done += grow
                    # the launch grew, so this worker's whole queue (the
                    # launch plus anything accepted after it) shifts by
                    # the same amount -- never rewind free_at
                    self.free_at[open_.worker] += grow
                    return open_, False, new_seg, False
        i = int(np.argmin(self.free_at))
        start = max(arrival, self.free_at[i]) + self.batch_window
        launch = _Launch(key=key, start=start,
                         done=start + overhead + stream + marginal,
                         worker=i, seg_rows={key: max(cand_rows, 0)},
                         seg_full={key: full_rows},
                         solo_cand=solo_cand, frags={frag_key})
        self.free_at[i] = launch.done
        if self.batch_window > 0.0:
            self._open[key] = launch
            self._open_any = launch
        return launch, True, True, False


@dataclasses.dataclass
class _ClientState:
    qi: int = 0                 # index into the client's query sequence
    ev: int = 0                 # next event within the current query
    query_start: float = 0.0
    timed_out: bool = False


def simulate(traces_per_client: Sequence[Sequence[QueryTrace]],
             params: SimParams,
             cache_size: Optional[int] = None,
             use_cache: bool = False,
             wrap: bool = False) -> SimResult:
    """Replay per-client query streams through the queueing model.

    Event-granular interleaving: the heap orders *individual requests*
    across all clients, so server FIFO contention and shared-cache state
    evolve in global time order, as they would on the paper's cluster.
    Clients restart their sequence if they exhaust it before the hour is
    up (the paper's per-core 193-query sequences were sized not to).
    """
    server = _Server(params.server_workers,
                     batch_window=params.batch_window_s,
                     fuse=params.fuse_patterns,
                     max_segments=params.fused_max_segments,
                     max_stream=params.fused_max_stream)
    cache = LRUCache(cache_size) if use_cache else None
    # Unified-store memo model: LRU set of fragment keys served so far.
    # A later request for a resident fragment skips its launch entirely
    # -- served at servlet overhead, exactly like the real server's
    # fragment store (whose async front end fast-paths resident pages
    # instead of holding them for the batching window, and whose batch
    # planner counts every same-key request beyond a prefilled
    # selection's consumer as a store hit). Skip accounting applies to
    # accelerated-backend replays only, mirroring
    # ``Counters.launches_skipped``.
    # frag_key -> name of the query that computed it. The owner matters
    # for kernel replays: a repeat EXECUTION of the same query finds its
    # fragments resident (the live store skips those launches), whereas
    # a cand > 0 event from a DIFFERENT query is trace evidence that the
    # real store had evicted the fragment by then -- it must launch.
    memo: "OrderedDict[tuple, str]" = OrderedDict()
    kernel_replay = any(
        isinstance(ev, HttpRecord) and ev.cand > 0
        for traces in traces_per_client
        for trace in traces for ev in trace.events)
    sim_launches = kernel_requests = sim_skips = sim_cand = sim_rows = 0
    # per-shard planned-window-page accumulator (sharded traces only:
    # grows to the widest shard_pages delta seen; stays [] otherwise)
    shard_acc: List[int] = []
    completed = timeouts = attempted = 0
    qet_sum = 0.0
    qets: List[float] = []

    states = [_ClientState() for _ in traces_per_client]
    heap: List[Tuple[float, int]] = [(0.0, ci)
                                     for ci in range(len(states))]
    heapq.heapify(heap)
    launches: List[_Launch] = []   # launch i <-> heap id -(i + 1)
    events = 0
    frontier = 0.0
    depth = max(params.pipeline_depth, 1)

    def resume_waiters(launch: _Launch) -> None:
        # every member of a grouped launch completes at the final done
        for wci, wev in launch.waiters:
            wt = (launch.done + params.net_latency_s / depth
                  + wev.recv * params.bytes_per_triple
                  / params.bandwidth_bps
                  + params.client_overhead_s / depth)
            heapq.heappush(heap, (wt, wci))

    while heap:
        t, ci = heapq.heappop(heap)
        frontier = max(frontier, min(t, params.duration_s))
        if ci < 0:
            launch = launches[-ci - 1]
            if t < launch.done:     # grew after this event was queued
                heapq.heappush(heap, (launch.done, ci))
            else:
                resume_waiters(launch)
            continue
        if t >= params.duration_s:
            continue
        st = states[ci]
        traces = traces_per_client[ci]
        trace = traces[st.qi % len(traces)]

        if st.ev == 0:
            st.query_start = t
            st.timed_out = not trace.completed  # budget-truncated trace

        # Query finished (all events done, or timeout crossed)?
        over = t - st.query_start > params.timeout_s
        if st.ev >= len(trace.events) or st.timed_out or over:
            if st.timed_out or over:
                t = min(t, st.query_start + params.timeout_s)
                if t <= params.duration_s:
                    timeouts += 1
                    attempted += 1
            else:
                completed += 1
                attempted += 1
                qet_sum += t - st.query_start
                qets.append(t - st.query_start)
            st.qi += 1
            st.ev = 0
            st.timed_out = False
            # per-execution client restart (the paper restarts the client
            # process between executions); also guarantees time progress
            t += 0.01
            if st.qi < len(traces) or wrap:
                heapq.heappush(heap, (t, ci))
            continue

        ev = trace.events[st.ev]
        st.ev += 1
        events += 1
        if events > params.max_events:
            break
        if isinstance(ev, HttpRecord):
            t += params.net_latency_s / depth
            frag_key = ev.key[:2]   # page-independent fragment identity
            hit = False
            if cache is not None:
                hit = cache.get(ev.key) is not None
                if not hit:
                    cache.put(ev.key, True)
            if hit:
                t += params.cache_hit_s
                if kernel_replay:
                    sim_skips += 1   # page resident: launch avoided
            elif frag_key in memo and not (
                    kernel_replay and ev.cand > 0
                    and memo[frag_key] != trace.name):
                # unified-store skip: the fragment was computed by an
                # earlier request -- served from the memo at servlet
                # overhead, no launch. Kernel traces encode collection-
                # time residency: a cand > 0 event means the real server
                # streamed candidates, i.e. its store had EVICTED any
                # earlier copy -- unless the earlier copy came from a
                # prior execution of this same query (trace duplication
                # across clients / wrap-around), which collection never
                # saw and which the live store serves residency-free.
                memo.move_to_end(frag_key)
                if kernel_replay:
                    sim_skips += 1
                    kernel_requests += 1
                t = server.schedule(t, params.req_overhead_s)
            elif ev.cand > 0:
                # kernel-backend request: per-launch cost model, with
                # optional cross-request batching on the pattern key.
                # ``cand`` already sums the candidate rows streamed over
                # all of the request's launches (window pages on the
                # sharded backend run as separate launches -- on every
                # shard in parallel -- so each pays dispatch overhead
                # but the HBM stream total is just ``cand``).
                n_launch = max(ev.launches, 1)
                overhead = n_launch * params.kernel_launch_overhead_s
                stream = ev.cand * params.kernel_stream_s
                # per-request work that never batches: HTTP handling +
                # this request's own pattern-slot compare cells (pats
                # sums per-launch slot counts, so the per-launch grid is
                # cand/n * pats/n cells, summed over n launches).
                marginal = (params.req_overhead_s
                            + ev.cand * ev.pats
                            * params.kernel_cell_s / n_launch)
                launch, created, new_seg, dup = server.schedule_launch(
                    t, ev.pattern_key, overhead, stream, marginal,
                    cand_rows=ev.cand_rows or ev.cand,
                    solo_cand=ev.cand, frag_key=frag_key,
                    full_rows=ev.cand_full_rows)
                kernel_requests += 1
                if dup and kernel_replay:
                    # same-fragment repeat inside the window: the live
                    # batch planner serves it from the prefill memo and
                    # counts a store skip, not a new launch member
                    sim_skips += 1
                # a created request stands for all of its window
                # launches (1 on the single-host kernel path); a
                # joining request rides them and creates none. A
                # same-pattern joiner streams no candidates of its own;
                # a cross-pattern joiner fused in as a new segment DOES
                # stream its own candidate block. Streamed-row totals
                # for batched launches are settled at the end (the
                # launch's padding depends on whether it fused), so only
                # the unbatched path charges here.
                sim_launches += n_launch if created else 0
                # shard-heat model: a created request's window pages land
                # on the shards its trace recorded (a same-pattern joiner
                # rides the open launch's pages and adds none; a fused
                # new segment brings its own page spans, which the live
                # placed planner also charges per segment).
                if (created or new_seg) and ev.shard_pages:
                    if len(shard_acc) < len(ev.shard_pages):
                        shard_acc.extend(
                            [0] * (len(ev.shard_pages) - len(shard_acc)))
                    for si, pg in enumerate(ev.shard_pages):
                        shard_acc[si] += int(pg)
                if params.batch_window_s <= 0.0:
                    sim_cand += ev.cand if created else 0
                    sim_rows += (ev.cand_rows or ev.cand) if created else 0
                # the launch leaves this fragment resident in the
                # modeled unified store
                memo[frag_key] = trace.name
                memo.move_to_end(frag_key)
                while len(memo) > params.selector_memo_entries:
                    memo.popitem(last=False)
                if params.batch_window_s > 0.0:
                    # block this client on the launch: it resumes (with
                    # its response transfer) when the launch completes,
                    # which may move later if more requests join.
                    launch.waiters.append((ci, ev))
                    if created:
                        launches.append(launch)
                        heapq.heappush(heap,
                                       (launch.done, -len(launches)))
                    continue
                t = launch.done
            else:
                service = (params.req_overhead_s
                           + ev.lookups * params.lookup_s
                           + ev.scanned * params.scan_s_per_triple)
                t = server.schedule(t, service)
                # served -> resident (repeats of this fragment skip)
                memo[frag_key] = trace.name
                memo.move_to_end(frag_key)
                while len(memo) > params.selector_memo_entries:
                    memo.popitem(last=False)
            t += (params.net_latency_s / depth
                  + ev.recv * params.bytes_per_triple
                  / params.bandwidth_bps)
            t += params.client_overhead_s / depth
        else:  # ('join', units)
            t += ev[1] * params.join_s_per_triple
        heapq.heappush(heap, (t, ci))

    simulated = (params.duration_s if events <= params.max_events
                 else frontier)
    # fused-shape tallies: every created launch under batching is in
    # ``launches``; one that accumulated >= 2 distinct pattern keys
    # modelled a cross-pattern fused launch (Counters.fused_launches).
    # Its stream is the segments' tile-aligned blocks padded to a pow2
    # tile count (``select_fused``); a singleton launch pads its block
    # to the solo shape bucket instead, which the trace already carries.
    fused = [ln for ln in launches if len(ln.keys) > 1]
    for ln in launches:
        streamed = ln.seg_streamed()
        sim_rows += sum(streamed)
        if len(ln.keys) > 1:
            sim_cand += _pow2_at_least(ln.stream_tiles()) * _FUSED_BT
        else:
            # same-pattern joiners grew the union block (capped at the
            # full range); the solo shape bucket (already pow2,
            # min-bucket floored) is the floor
            sim_cand += max(ln.solo_cand, _pow2_at_least(sum(streamed)))
    return SimResult(completed, timeouts, attempted, qet_sum, qets,
                     simulated_s=max(simulated, 1e-9),
                     launches=sim_launches,
                     kernel_requests=kernel_requests,
                     launches_skipped=sim_skips,
                     fused_launches=len(fused),
                     fused_segments=sum(len(ln.keys) for ln in fused),
                     cand_streamed=sim_cand, cand_rows=sim_rows,
                     shard_launches=tuple(shard_acc))


def split_workload(workload, num_clients: int):
    """Partition the workload into per-client disjoint sequences
    (the paper splits 12,400 queries into 64 distinct sets)."""
    per = max(1, len(workload) // num_clients)
    return [workload[i * per:(i + 1) * per] or workload[:per]
            for i in range(num_clients)]


# ---------------------------------------------------------------------------
# Live validation: replay traces through the REAL async front end
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LiveValidation:
    """Simulated vs observed launch counts for one trace replay.

    ``simulated`` comes from the cost model's launch bookkeeping
    (:attr:`SimResult.launches`); ``observed`` from actually pushing the
    same request streams through ``AsyncBrTPFServer`` over a
    kernel-backend server and reading ``Counters.kernel_launches``. The
    two use different clocks (simulated seconds vs wall time), so exact
    equality is not expected -- agreement within ~10% validates that the
    sim's batching window models what the server now really does.
    """

    simulated_launches: int
    observed_launches: int
    requests: int
    observed_batched: int     # requests served via shared grouped launches
    flushes: int
    # unified-fragment-store validation: launches each side SKIPPED
    # because the request's fragment was already resident (sim: the
    # memo model; observed: Counters.launches_skipped).
    simulated_skipped: int = 0
    observed_skipped: int = 0
    # Omega-restricted pruning validation: candidate rows streamed by
    # the launches each side created (sim: SimResult.cand_streamed over
    # the pruned traces; observed: Counters.kernel_cand_streamed).
    # Grouped live launches stream ONE (padded) block for the whole
    # group while the sim charges the creating request's solo stream,
    # so agreement is approximate under batching -- but both collapse
    # together when pruning shrinks the streams.
    simulated_cand: int = 0
    observed_cand: int = 0
    # raw (pre-padding) candidate rows. The padded totals above shift
    # with how requests regroup into launches (pow2/tile padding is not
    # additive); raw rows are composition-invariant, so this is the
    # tight streaming-agreement check under fusion.
    simulated_cand_rows: int = 0
    observed_cand_rows: int = 0
    # cross-pattern fusion validation: launches that served >= 2
    # distinct patterns (sim: _Launch.keys; observed:
    # Counters.fused_launches) and their total segment counts.
    simulated_fused: int = 0
    observed_fused: int = 0
    simulated_fused_segments: int = 0
    observed_fused_segments: int = 0
    # shard-heat validation (sharded backend only; empty tuples
    # otherwise): per-shard planned-window-page totals (sim:
    # SimResult.shard_launches from the traces' shard_pages deltas;
    # observed: BrTPFServer.shard_launch_snapshot deltas) -- the
    # placement layer's per-shard agreement surface.
    simulated_shard: tuple = ()
    observed_shard: tuple = ()
    # resilience cross-check (docs/resilience.md): replayed requests
    # carry no deadlines, so the live front end must shed NOTHING --
    # a non-zero count here means expired-deadline shedding leaked into
    # a deadline-free replay and the launch comparison above is void.
    observed_shed: int = 0

    @property
    def agreement(self) -> float:
        """observed / simulated launch ratio (1.0 = perfect)."""
        return self.observed_launches / max(self.simulated_launches, 1)

    @property
    def within(self) -> float:
        """Relative disagreement |obs - sim| / sim."""
        return (abs(self.observed_launches - self.simulated_launches)
                / max(self.simulated_launches, 1))

    @property
    def skip_within(self) -> float:
        """Relative skipped-launch disagreement |obs - sim| / max(sim, 1)."""
        return (abs(self.observed_skipped - self.simulated_skipped)
                / max(self.simulated_skipped, 1))

    @property
    def cand_within(self) -> float:
        """Relative streamed-candidate disagreement |obs - sim| / max(sim, 1)."""
        return (abs(self.observed_cand - self.simulated_cand)
                / max(self.simulated_cand, 1))

    @property
    def cand_rows_within(self) -> float:
        """Relative raw-candidate-row disagreement |obs - sim| / max(sim, 1)."""
        return (abs(self.observed_cand_rows - self.simulated_cand_rows)
                / max(self.simulated_cand_rows, 1))

    @property
    def shard_within(self) -> float:
        """Total per-shard page disagreement: sum_s |obs_s - sim_s| /
        max(sum_s sim_s, 1). Zero-pads the shorter side, so a shard one
        side never touched still counts as disagreement."""
        n = max(len(self.simulated_shard), len(self.observed_shard))
        sim = list(self.simulated_shard) + [0] * (n - len(self.simulated_shard))
        obs = list(self.observed_shard) + [0] * (n - len(self.observed_shard))
        return (sum(abs(o - s) for o, s in zip(obs, sim, strict=True))
                / max(sum(sim), 1))


def requests_from_trace(trace: QueryTrace) -> List["object"]:
    """Rebuild the :class:`~repro_torch.core.server.Request` sequence of a
    trace (join events are client-local and carry no request)."""
    from .rdf import TriplePattern
    from .server import Request
    reqs = []
    for ev in trace.events:
        if not isinstance(ev, HttpRecord):
            continue
        pattern_tuple, omega_rows, page = ev.key
        omega = (None if not omega_rows
                 else np.asarray(omega_rows, dtype=np.int32))
        reqs.append(Request(TriplePattern(*pattern_tuple), omega, page))
    return reqs


def live_replay(traces_per_client: Sequence[Sequence[QueryTrace]],
                server: BrTPFServer,
                params: SimParams,
                batch_window_s: float = 2e-3,
                max_batch: int = 64) -> LiveValidation:
    """Validate the sim's launch model against the real front end.

    Replays each client's request stream through an
    :class:`~repro_torch.core.batching.AsyncBrTPFServer` wrapped around
    ``server`` (which must use the kernel backend for launch counts to
    be meaningful), runs the cost-model replay of the *same* traces, and
    reports both launch counts side by side -- including the launches
    each side *skipped* via the unified fragment store. Each live client awaits its
    responses in order, mirroring the sim's one-outstanding-request-per-
    client-per-stream structure.
    """
    from .batching import serve_concurrent
    # The live loop drives ONE in-process server: flushes serialize on
    # the event loop, so the matching cost model is a single worker --
    # an open launch then stays joinable while the previous flush is
    # still executing, exactly like the real pending-batch queue.
    sim_params = dataclasses.replace(params, batch_window_s=batch_window_s,
                                     server_workers=1)
    sim = simulate(traces_per_client, sim_params)

    streams = [[req for trace in traces for req in requests_from_trace(trace)]
               for traces in traces_per_client]
    base = server.counters.snapshot()
    shard_snap = getattr(server, "shard_launch_snapshot", None)
    shard_before = shard_snap() if shard_snap is not None else None
    _responses, front = serve_concurrent(
        server, streams, batch_window_s=batch_window_s, max_batch=max_batch)
    after = server.counters
    shard_obs = ()
    if shard_before is not None and shard_before.size:
        shard_obs = tuple(
            int(x) for x in (shard_snap() - shard_before).tolist())
    return LiveValidation(
        simulated_launches=sim.launches,
        observed_launches=after.kernel_launches - base.kernel_launches,
        requests=front.stats.requests + front.stats.fast_path,
        observed_batched=(after.kernel_batched_requests
                          - base.kernel_batched_requests),
        flushes=front.stats.flushes,
        simulated_skipped=sim.launches_skipped,
        observed_skipped=(after.launches_skipped
                          - base.launches_skipped),
        simulated_cand=sim.cand_streamed,
        observed_cand=(after.kernel_cand_streamed
                       - base.kernel_cand_streamed),
        simulated_cand_rows=sim.cand_rows,
        observed_cand_rows=(after.kernel_cand_rows
                            - base.kernel_cand_rows),
        simulated_fused=sim.fused_launches,
        observed_fused=after.fused_launches - base.fused_launches,
        simulated_fused_segments=sim.fused_segments,
        observed_fused_segments=(after.fused_segments
                                 - base.fused_segments),
        simulated_shard=sim.shard_launches,
        observed_shard=shard_obs,
        observed_shed=front.stats.shed,
    )


def main(argv=None) -> int:
    """CLI: replay a small WatDiv workload through the cost model and
    (with ``--live``) through the real async front end.

    Example::

        python -m repro_torch.core.sim --live --clients 16 --window 2e-3
    """
    import argparse
    parser = argparse.ArgumentParser(
        description="brTPF multi-client replay: cost model vs live front end")
    parser.add_argument("--live", action="store_true",
                        help="also replay through AsyncBrTPFServer and "
                             "report observed launch counts")
    parser.add_argument("--clients", type=int, default=16)
    parser.add_argument("--queries", type=int, default=12)
    parser.add_argument("--backend", choices=("kernel", "sharded"),
                        default="kernel",
                        help="selector backend for trace collection and "
                             "the live server. 'sharded' replays the "
                             "shard-heat model and validates per-shard "
                             "page counts over --shards logical shards")
    parser.add_argument("--shards", type=int, default=1,
                        help="logical shards of the sharded backend")
    parser.add_argument("--shard-window", type=int, default=None,
                        help="sharded-backend window rows per launch "
                             "(default: the backend's own choice)")
    parser.add_argument("--device", default=None,
                        help="torch device of the backends (default: "
                             "CUDA, where the kernel profile is timed "
                             "with calibrate_kernels; 'cpu' runs the "
                             "kernels' plain versions and keeps the "
                             "SimParams defaults)")
    parser.add_argument("--window", type=float, default=2e-3,
                        help="batching window in seconds (sim and live)")
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument("--max-mpr", type=int, default=30)
    parser.add_argument("--no-fuse", action="store_true",
                        help="disable cross-pattern kernel fusion in both "
                             "the cost model and the live server (A/B)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from ..data.watdiv import WatDivScale, generate, generate_workload
    scale = WatDivScale(users=600, products=240, reviews=1000,
                        retailers=12, genres=15, cities=20, tags=40)
    data = generate(scale, seed=args.seed)
    workload = generate_workload(data, args.queries, seed=args.seed + 1)

    config = ServerConfig(max_mpr=args.max_mpr,
                          selector_backend=args.backend,
                          device=args.device, shards=args.shards,
                          shard_window=args.shard_window,
                          fuse_patterns=not args.no_fuse)
    server = BrTPFServer(data.store, config)
    traces = collect_traces(server, workload, "brtpf",
                            max_mpr=args.max_mpr)
    params = calibrate(server, workload)
    from ..kernels.ops import resolve_device
    if resolve_device(args.device).type == "cuda":
        params = dataclasses.replace(params, **calibrate_kernels(args.device))
        print("kernel profile: " + " ".join(
            f"{k}={getattr(params, k):.3e}" for k in (
                "kernel_launch_overhead_s", "kernel_cell_s",
                "kernel_stream_s")))
    params.batch_window_s = args.window
    params.fuse_patterns = not args.no_fuse
    per_client = split_workload(traces, args.clients)

    sim = simulate(per_client, params)
    print(f"sim: clients={args.clients} window={args.window:g}s "
          f"fuse={not args.no_fuse} "
          f"completed={sim.completed} kernel_requests={sim.kernel_requests} "
          f"launches={sim.launches} "
          f"launches_per_request={sim.launches_per_request:.3f} "
          f"launches_skipped={sim.launches_skipped} "
          f"fused_launches={sim.fused_launches} "
          f"fused_segments_per_launch={sim.fused_segments_per_launch:.2f} "
          f"cand_streamed={sim.cand_streamed} "
          f"cand_per_request={sim.cand_per_request:.0f}")
    if not args.live:
        return 0

    live_server = BrTPFServer(data.store, config)
    lv = live_replay(per_client, live_server, params,
                     batch_window_s=args.window, max_batch=args.max_batch)
    print(f"live: requests={lv.requests} flushes={lv.flushes} "
          f"observed_launches={lv.observed_launches} "
          f"batched_requests={lv.observed_batched} "
          f"observed_skipped={lv.observed_skipped}")
    print(f"validation: simulated={lv.simulated_launches} "
          f"observed={lv.observed_launches} "
          f"agreement={lv.agreement:.3f} "
          f"(|rel err|={lv.within:.1%})")
    print(f"validation(skips): simulated={lv.simulated_skipped} "
          f"observed={lv.observed_skipped} "
          f"(|rel err|={lv.skip_within:.1%})")
    print(f"validation(cand): simulated={lv.simulated_cand} "
          f"observed={lv.observed_cand} "
          f"(|rel err|={lv.cand_within:.1%})")
    print(f"validation(cand_rows): simulated={lv.simulated_cand_rows} "
          f"observed={lv.observed_cand_rows} "
          f"(|rel err|={lv.cand_rows_within:.1%})")
    print(f"validation(fused): simulated={lv.simulated_fused} launches / "
          f"{lv.simulated_fused_segments} segments, "
          f"observed={lv.observed_fused} / {lv.observed_fused_segments}")
    if args.backend == "sharded":
        print(f"validation(shard): simulated={list(lv.simulated_shard)} "
              f"observed={list(lv.observed_shard)} "
              f"(|rel err|={lv.shard_within:.1%})")
    # The live loop reports through the SAME canonical snapshot schema
    # the serving edge exposes at GET /metrics (core/metrics.py), so a
    # number printed here is directly comparable to what the load
    # generator (benchmarks/latency.py) reads over the wire.
    snap = live_server.metrics_snapshot()
    c = snap["counters"]
    print(f"metrics[{snap['v']}]: num_requests={c['num_requests']} "
          f"kernel_launches={c['kernel_launches']} "
          f"fused_launches={c['fused_launches']} "
          f"fused_segments_per_launch="
          f"{snap['fused_segments_per_launch']:.2f} "
          f"kernel_batched_requests={c['kernel_batched_requests']} "
          f"launches_skipped={snap['launches_skipped']} "
          f"selector_memo_hit_rate="
          f"{snap['selector_memo']['hit_rate']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
