"""The serving path's spans (``repro_torch.core.trace``) on the CPU.

* With no profiler, a batch served through ``app_from_config`` and
  ``AsgiTransport`` records nothing, and its fragments are byte-identical
  to the same batch served under a profiler.
* Under ``torch.profiler`` (CPU activity), on the kernel and the sharded
  backend, inline and on an executor: each request has one ``request``,
  one ``front`` and, when batched, one ``wait`` span under one id; each
  ``flush`` names its members and its cause; every phase nests in its
  flush, and the phases of a flush never overlap, also where one selector
  path calls another (``select_with_cnt`` through
  ``select_same_pattern``, a fused launch's grouped fallback); the
  server's own work after a selector returns is counted in the server's
  phase, not in the selector's last one.
* The ring counts the spans it drops when full; ``RouteLatency`` takes
  the request span's own two clock readings.
* ``CudaWork.rows_back`` counts the rows every ``collect`` copied back,
  on both backends; the store's build record holds every phase.
* Each span's ``record_function`` range in the profile lies within 50 us
  of its stamps once mapped by one offset read at the profile's start
  (the method of ``bench/devprof.py``); on the card, each ``copy_in``
  span holds the CUDA launches and copies it issued.
"""
import asyncio
import collections
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.core as tcore
from repro_torch.core import trace
from repro_torch.core.batching import AsyncBrTPFServer
from repro_torch.core.federation import ShardedSelector
from repro_torch.core.kernel_selectors import FusedSegment, KernelSelector
from repro_torch.core.server import BrTPFServer
from repro_torch.core.wire import dumps, fragment_to_wire
from repro_torch.serving.http import BrTPFApp, app_from_config
from repro_torch.serving.transport import AsgiTransport

pytestmark = pytest.mark.tier1

V = tcore.encode_var
HOST_ISSUES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
               "cuMemcpy")


def store_array(seed=0, n=600, terms=18):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, terms, size=(n, 3)).astype(np.int32),
                     axis=0)


ARR = store_array()


def requests(count=24, seed=3):
    """Mixed TPF/brTPF page requests over patterns of the store."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        s, p, o = (int(x) for x in ARR[rng.integers(len(ARR))])
        tp = tcore.TriplePattern(*[(V(0), p, o), (s, p, V(0)),
                                   (V(0), p, V(1)), (V(0), V(1), o)][i % 4])
        omega = None
        if i % 3:
            omega = rng.integers(0, 18, size=(int(rng.integers(1, 30)),
                                              len(tp.variables())))
            omega = omega.astype(np.int32)
        out.append(tcore.Request(pattern=tp, omega=omega))
    return out


def config(backend):
    return tcore.ServerConfig(selector_backend=backend, device="cpu",
                              shards=4 if backend == "sharded" else 1)


def serve(backend="kernel", executor=None, app=None):
    """Serve 24 concurrent requests (three full flushes of 8), then 5
    more (a timer flush) and 4 repeats (resident pages), through the
    HTTP edge; return the app and the fragments' wire bytes."""
    if app is None:
        front = AsyncBrTPFServer.from_config(tcore.TripleStore(ARR),
                                             config(backend), max_batch=8,
                                             executor=executor)
        app = BrTPFApp(front)
    transport = AsgiTransport(app)
    reqs = requests()

    async def main():
        frags = await asyncio.gather(*[transport.handle(r) for r in reqs])
        frags += await asyncio.gather(*[transport.handle(r)
                                        for r in requests(5, seed=11)])
        frags += await asyncio.gather(*[transport.handle(r)
                                        for r in reqs[:4]])
        await app.aclose()
        return frags

    frags = asyncio.run(main())
    return app, [dumps(fragment_to_wire(f)) for f in frags]


def traced(fn, *args, **kw):
    """``fn`` under a CPU profile; the spans it recorded, and the
    profile with the offset that maps perf_counter onto its clock."""
    trace.TRACE.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("first"):   # a session's first range is slow
            pass
        offset_ns = time.time_ns() - time.perf_counter() * 1e9
        out = fn(*args, **kw)
    return out, trace.TRACE.spans(0.0, float("inf")), prof, offset_ns


def by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def check_phases(spans, flushes):
    """Every phase span is a child of a flush, inside it, and the
    phases of one flush follow one another without overlap."""
    flush = {f.id: f for f in flushes}
    kids = collections.defaultdict(list)
    for s in spans:
        if s.name in trace.PHASES:
            assert s.parent in flush, s
            kids[s.parent].append(s)
    for fid, phases in kids.items():
        f = flush[fid]
        phases.sort(key=lambda s: s.t0)
        assert f.t0 <= phases[0].t0 and phases[-1].t1 <= f.t1
        for a, b in zip(phases, phases[1:]):
            assert a.t1 <= b.t0, (a, b)
    return kids


def test_no_profiler_records_nothing_and_serves_the_same_bytes():
    trace.TRACE.clear()
    front = app_from_config(tcore.TripleStore(ARR), config("kernel"),
                            max_batch=8)
    _, off = serve(app=front)
    assert trace.TRACE.spans(0.0, float("inf")) == []
    assert trace.TRACE.dropped() == 0
    (_, on), spans, _, _ = traced(serve, "kernel")
    assert spans and on == off


@pytest.mark.parametrize("backend,pool", [("kernel", False),
                                          ("sharded", False),
                                          ("kernel", True),
                                          ("sharded", True)])
def test_each_request_and_flush_is_spanned(backend, pool):
    executor = ThreadPoolExecutor(1) if pool else None
    try:
        _, spans, _, _ = traced(serve, backend, executor)
    finally:
        if executor is not None:
            executor.shutdown()
    named = by_name(spans)
    assert len(named["request"]) == len(named["front"]) == 33
    front_of = {f.parent: f for f in named["front"]}
    wait_of = {w.parent: w for w in named["wait"]}
    assert len(front_of) == 33 and len(wait_of) == len(named["wait"])
    ids = set()
    for r in named["request"]:
        f = front_of[r.id]
        assert f.req == r.req and r.t0 <= f.t0 <= f.t1 <= r.t1
        ids.add(r.req)
        if f.id in wait_of:
            w = wait_of[f.id]
            assert w.req == r.req and f.t0 <= w.t0 <= w.t1 <= f.t1
    assert len(ids) == 33
    # the 4 repeats are resident: served at once, never batched
    assert len(named["wait"]) == 29
    members = [m for f in named["flush"] for m in f.req]
    assert sorted(members) == sorted(w.req for w in named["wait"])
    waits = {w.req: w for w in named["wait"]}
    causes = collections.Counter(f.cause for f in named["flush"])
    if pool:
        # the loop takes arrivals during a flush: batches vary
        assert set(causes) <= {"full", "timer"} and causes["timer"] >= 1
    else:
        assert causes == {"full": 3, "timer": 1}
    for f in named["flush"]:
        assert all(waits[m].t1 <= f.t0 for m in f.req)
        assert f.parent == 0
        if f.cause == "timer":
            assert f.due is not None and f.due <= f.t0
        else:
            assert f.due is None
    kids = check_phases(spans, named["flush"])
    seen = {s.name for phases in kids.values() for s in phases}
    assert seen == set(trace.PHASES)


def selector(backend):
    store = tcore.TripleStore(ARR)
    if backend == "kernel":
        return KernelSelector(store, device="cpu")
    from repro_torch.core.federation import FederatedStore
    return ShardedSelector(FederatedStore.build(ARR, shards=4,
                                                device="cpu"))


def fallback_segments():
    """Two TPF segments over two predicates of the store that may not
    fuse (one declares a dependency): each takes its own grouped
    launch."""
    p0, p1 = (int(p) for p in np.unique(ARR[:, 1])[:2])
    return [FusedSegment(tp=tcore.TriplePattern(V(0), p0, V(1)),
                         omegas=[None]),
            FusedSegment(tp=tcore.TriplePattern(V(0), p1, V(1)),
                         omegas=[None], depends_on=(0,))]


@pytest.mark.parametrize("backend", ["kernel", "sharded"])
@pytest.mark.parametrize("path", ["select_with_cnt", "fused_fallback"])
def test_one_path_through_another_counts_each_phase_once(backend, path):
    sel = selector(backend)
    req = next(r for r in requests() if r.omega is not None)

    def run():
        flush = trace.Flush([], "inline", None)
        try:
            if path == "select_with_cnt":
                flush.bind(sel.select_with_cnt)(req.pattern, req.omega)
            else:
                flush.bind(sel.select_fused)(fallback_segments())
        finally:
            flush.close()

    _, spans, _, _ = traced(run)
    named = by_name(spans)
    (flush,) = named["flush"]
    kids = check_phases(spans, [flush])[flush.id]
    assert {s.name for s in kids} == set(trace.PHASES)
    assert sum(s.t1 - s.t0 for s in kids) <= flush.t1 - flush.t0
    if backend == "kernel":
        # one kernel call a launch, each spanned once
        assert len([s for s in kids if s.name == "copy_in"]) \
            == sel.cuda.launches
    if path == "fused_fallback":
        assert len([s for s in kids if s.name == "order"]) == 2


def selector_batches():
    """One batch for each server path that calls a selector: a grouped
    prefill (two requests, one pattern), a fused prefill (two patterns),
    a solo request and a solo count probe."""
    rng = np.random.default_rng(5)
    p0, p1 = (int(p) for p in np.unique(ARR[:, 1])[:2])

    def req(p, count_only=False):
        omega = rng.integers(0, 18, size=(6, 2)).astype(np.int32)
        return tcore.Request(pattern=tcore.TriplePattern(V(0), p, V(1)),
                             omega=omega, count_only=count_only)

    return [[req(p0), req(p0)], [req(p0), req(p1)], [req(p1)],
            [req(p0, count_only=True)]]


@pytest.mark.parametrize("backend", ["kernel", "sharded"])
def test_the_servers_work_after_a_selector_returns_is_its_own(
        backend, monkeypatch):
    """Each selector entry is made to end in ``collect``: the launch
    accounting the server does once it returns still lies in a
    ``serve`` span, on all four paths."""
    cls = KernelSelector if backend == "kernel" else ShardedSelector
    for name in ("select_same_pattern", "select_fused", "select_count"):
        def ends_in_collect(self, *args, _orig=getattr(cls, name), **kw):
            out = _orig(self, *args, **kw)
            trace.phase("collect")
            return out
        monkeypatch.setattr(cls, name, ends_in_collect)
    charged = []
    charge = BrTPFServer._charge_launches

    def timed_charge(self, *args, **kw):
        t0 = time.perf_counter_ns()
        charge(self, *args, **kw)
        time.sleep(1e-3)
        charged.append((t0, time.perf_counter_ns()))

    monkeypatch.setattr(BrTPFServer, "_charge_launches", timed_charge)

    def run():
        for batch in selector_batches():
            server = BrTPFServer(tcore.TripleStore(ARR), config(backend))
            flush = trace.Flush([], "inline", None)
            try:
                flush.bind(server.handle_batch)(batch)
            finally:
                flush.close()

    _, spans, _, _ = traced(run)
    named = by_name(spans)
    check_phases(spans, named["flush"])
    assert len(charged) >= 4
    for a, b in charged:
        assert any(s.t0 <= a and b <= s.t1 for s in named["serve"]), \
            (a, b, [(s.name, s.t0, s.t1) for s in spans
                    if s.t0 <= b and a <= s.t1])


def test_the_ring_counts_what_it_drops(monkeypatch):
    ring = trace.SpanRing(capacity=4)
    for i in range(10):
        ring.add(trace.Span("x", i + 1, 0, i, 10 * i, 10 * i + 5))
    assert ring.dropped() == 6
    assert [s.id for s in ring.spans(0.0, 1.0)] == [7, 8, 9, 10]
    assert [s.id for s in ring.spans(64e-9, 66e-9)] == [7]
    small = trace.SpanRing(capacity=16)
    monkeypatch.setattr(trace, "TRACE", small)
    with profile(activities=[ProfilerActivity.CPU]):
        serve()
    assert small.dropped() > 0
    assert len(small.spans(0.0, float("inf"))) == 16


def test_threads_lose_no_span_and_share_no_id(monkeypatch):
    """Flushes on executor threads add spans beside the loop's: with more
    threads than cores and a short switch interval, every span is held or
    counted as dropped, and no two spans share an id."""
    ring = trace.SpanRing(capacity=1000)
    monkeypatch.setattr(trace, "TRACE", ring)
    threads, each = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with ThreadPoolExecutor(threads) as pool:
                done = list(pool.map(
                    lambda _: [trace.Open("serve", 0, 0).close()
                               for _ in range(each)], range(threads),
                    timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert len(done) == threads
    held = ring.spans(0.0, float("inf"))
    assert len(held) == 1000
    assert len(held) + ring.dropped() == threads * each
    assert len({s.id for s in held}) == len(held)


@pytest.mark.parametrize("backend", ["kernel", "sharded"])
def test_rows_back_counts_the_rows_collect_returned(backend, monkeypatch):
    """``CudaWork.rows_back`` is the kept rows every compaction of the
    ``collect`` phase copied back, on both backends, fused and not."""
    import repro_torch.core.federation as tfed
    import repro_torch.core.kernel_selectors as tks
    returned = []
    real = tks.grouped_results

    def counting(*args, **kw):
        cnts, kept = real(*args, **kw)
        returned.append(sum(c.shape[0] for seg in kept for c, _ in seg))
        return cnts, kept

    monkeypatch.setattr(tks, "grouped_results", counting)
    monkeypatch.setattr(tfed, "grouped_results", counting)
    server = BrTPFServer(tcore.TripleStore(ARR), config(backend))
    server.handle_batch(requests())
    for req in requests(5, seed=11):
        server.handle(req)
    work = server.cuda_work()
    assert work.launches == len(returned)
    assert work.rows_back == sum(returned) > 0


def test_the_build_record_holds_every_phase():
    from repro_torch.core import metrics
    BrTPFServer(tcore.TripleStore(ARR), config("sharded"))
    rec = metrics.STORE_BUILD
    assert set(rec.host) == {"dedup", "pos", "osp"}
    assert set(rec.device) == {"spo", "pos", "osp", "copy"}
    assert rec.widths == {name: (21, 21, 21) for name in ("spo", "pos",
                                                          "osp")}
    assert all(v >= 0 for part in (rec.host, rec.device)
               for v in part.values())
    # a new store starts a new record: the kernel backend builds no
    # device store
    BrTPFServer(tcore.TripleStore(ARR), config("kernel"))
    assert set(metrics.STORE_BUILD.host) == {"dedup", "pos", "osp"}
    assert metrics.STORE_BUILD.device == {}


def test_route_latency_takes_the_request_spans_readings():
    (app, _), spans, _, _ = traced(serve, "kernel")
    samples = list(app.route_latency._samples["POST /fragment"])
    reqs = sorted(by_name(spans)["request"], key=lambda s: s.t1)
    assert samples == [(s.t1 - s.t0) / 1e9 for s in reqs]


def ranges_match(spans, prof, offset_ns, tol_ns=50_000):
    """Each span's record_function range, found by name, lies within
    ``tol_ns`` of its stamps mapped by ``offset_ns``; returns the
    profile's events."""
    events = list(prof.profiler.kineto_results.events())
    ranges = collections.defaultdict(list)
    for ev in events:
        if ev.name() in ("request", "front", "wait", "flush")\
                + trace.PHASES:
            ranges[ev.name()].append((ev.start_ns(),
                                      ev.start_ns() + ev.duration_ns()))
    for s in spans:
        a, b = s.t0 + offset_ns, s.t1 + offset_ns
        best = min(ranges[s.name],
                   key=lambda r: abs(r[0] - a) + abs(r[1] - b))
        assert abs(best[0] - a) <= tol_ns and abs(best[1] - b) <= tol_ns, \
            (s, best[0] - a, best[1] - b)
    return events


def test_record_function_ranges_lie_on_the_span_stamps():
    traced(serve, "sharded")      # first ranges pay a one-time set-up
    _, spans, prof, offset_ns = traced(serve, "sharded")
    assert spans
    ranges_match(spans, prof, offset_ns)


@pytest.mark.cuda
def test_on_the_card_copy_in_spans_hold_their_launches():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the spans of the kernel path on the "
                    "card are checked where one is")

    def run(backend):
        trace.TRACE.clear()
        front = AsyncBrTPFServer.from_config(
            tcore.TripleStore(ARR),
            tcore.ServerConfig(selector_backend=backend, device="cuda",
                               shards=4 if backend == "sharded" else 1),
            max_batch=8)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("first"):
                pass
            offset_ns = time.time_ns() - time.perf_counter() * 1e9
            serve(app=BrTPFApp(front))
            torch.cuda.synchronize()
        return trace.TRACE.spans(0.0, float("inf")), prof, offset_ns

    for backend in ("kernel", "sharded"):
        run(backend)
        spans, prof, offset_ns = run(backend)
        events = ranges_match(spans, prof, offset_ns)
        issued = sorted(ev.start_ns() for ev in events
                        if ev.name().startswith(HOST_ISSUES))
        copy_in = [s for s in spans if s.name == "copy_in"]
        assert copy_in
        for s in copy_in:
            a, b = s.t0 + offset_ns, s.t1 + offset_ns
            assert any(a <= t <= b for t in issued), (backend, s)
