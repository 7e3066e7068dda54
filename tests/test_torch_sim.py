"""The port's trace-replay simulator against the JAX package's, on the CPU.

* ``collect_traces`` records the same per-request events on both
  packages' servers (kernel backend, and the sharded backend at one
  shard): keys, rows scanned and received, candidate rows streamed,
  pattern slots and launches; the port's records also carry the CUDA
  kernels' own work (``live_slots``, ``cuda_launches``), which the
  selectors count beside the JAX package's accounting;
* the same traces through both packages' ``simulate`` with the same
  ``SimParams`` give equal ``SimResult``s, with and without batching,
  fusion and the shared cache;
* ``live_replay`` agrees with the live async front end within the JAX
  package's 10% bound (``tests/test_batching.py``'s case, and the port's
  own traces of a WatDiv-like workload);
* ``kernel_charge`` charges a record with those fields an overhead per
  CUDA launch and a cell per live slot, never more than the JAX
  package's charge, and a record without them (the JAX package's
  traces) exactly that charge;
* the port's ``SimParams`` carries none of the JAX package's TPU
  constants, and ``calibrate_kernels`` times only the card.

``SimParams`` is passed explicitly wherever the outcome depends on it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.sim as jsim
import repro.data.watdiv as jwatdiv
import repro_torch.core as tcore
import repro_torch.core.sim as tsim
import repro_torch.data.watdiv as twatdiv

pytestmark = pytest.mark.tier1

SCALE = dict(users=120, products=60, reviews=180, retailers=6, genres=8,
             cities=10, tags=12)
KERNEL_FIELDS = ("kernel_launch_overhead_s", "kernel_cell_s",
                 "kernel_stream_s")
# Explicit test values for the kernel profile (not a measurement).
TEST_PROFILE = dict(kernel_launch_overhead_s=5e-5, kernel_cell_s=5e-12,
                    kernel_stream_s=5e-11)


@pytest.fixture(scope="module")
def datasets():
    jdata = jwatdiv.generate(jwatdiv.WatDivScale(**SCALE), seed=3)
    terms = [jdata.dictionary.term(i) for i in range(len(jdata.dictionary))]
    tdict, tstore = twatdiv.from_arrays(jdata.store.triples, terms)
    return jdata, twatdiv.WatDivData(tdict, tstore,
                                     twatdiv.WatDivScale(**SCALE))


def workload(watdiv, data, per_family=1):
    out, seen = [], {}
    for name, bgp in watdiv.generate_workload(data, 60, seed=1):
        if seen.get(name[0], 0) < per_family:
            seen[name[0]] = seen.get(name[0], 0) + 1
            out.append((name, bgp))
    return out


def as_port(traces):
    """The JAX package's traces as the port's record types."""
    return [tsim.QueryTrace(t.name, [
        tsim.HttpRecord(**dataclasses.asdict(ev))
        if isinstance(ev, jsim.HttpRecord) else ev for ev in t.events],
        t.completed) for t in traces]


# the fields both packages' HttpRecords have
REF_FIELDS = tuple(f.name for f in dataclasses.fields(jsim.HttpRecord))
# the port's own: what the CUDA kernels did
CUDA_FIELDS = ("live_slots", "cuda_launches")


def events(traces):
    """Each trace's events, a record as its JAX package fields."""
    return [(t.name, t.completed, [
        {k: getattr(ev, k) for k in REF_FIELDS}
        if dataclasses.is_dataclass(ev) else ev
        for ev in t.events]) for t in traces]


def records(traces):
    return [ev for t in traces for ev in t.events
            if isinstance(ev, tsim.HttpRecord)]


@pytest.fixture(scope="module")
def kernel_traces(datasets):
    jdata, tdata = datasets
    jsrv = jcore.BrTPFServer(jdata.store, jcore.ServerConfig(
        selector_backend="kernel"))
    tsrv = tcore.BrTPFServer(tdata.store, tcore.ServerConfig(
        selector_backend="kernel", device="cpu"))
    return (jsim.collect_traces(jsrv, workload(jwatdiv, jdata), "brtpf",
                                request_budget=150),
            tsim.collect_traces(tsrv, workload(twatdiv, tdata), "brtpf",
                                request_budget=150))


def test_kernel_traces_equal_reference(kernel_traces):
    jtr, ttr = kernel_traces
    assert events(ttr) == events(jtr)
    recs = records(ttr)
    assert sum(r.launches for r in recs) > 0
    assert sum(r.cand for r in recs) > 0
    # one CUDA launch per LaunchRecord on the kernel backend, and the
    # live slots within the padded ones
    for r in recs:
        if r.cand > 0:
            assert r.cuda_launches == r.launches
            assert 0 < r.live_slots <= r.pats
        else:
            assert r.cuda_launches == r.live_slots == 0
    assert any(r.live_slots < r.pats for r in recs if r.cand > 0)


@pytest.mark.parametrize("kind", ["tpf", "sharded"])
def test_other_traces_equal_reference(datasets, kind):
    """TPF client traces on the numpy backend, and brTPF traces on the
    sharded backend at one shard (the JAX package over its one CPU
    device): launches count window pages, shard_pages each shard's."""
    jdata, tdata = datasets
    backend = "numpy" if kind == "tpf" else "sharded"
    client = "tpf" if kind == "tpf" else "brtpf"
    jsrv = jcore.BrTPFServer(jdata.store, jcore.ServerConfig(
        selector_backend=backend, shard_window=256))
    tsrv = tcore.BrTPFServer(tdata.store, tcore.ServerConfig(
        selector_backend=backend, shard_window=256, device="cpu"))
    jtr = jsim.collect_traces(jsrv, workload(jwatdiv, jdata)[:2], client,
                              request_budget=80)
    ttr = tsim.collect_traces(tsrv, workload(twatdiv, tdata)[:2], client,
                              request_budget=80)
    assert events(ttr) == events(jtr)
    recs = records(ttr)
    sel = tsrv._selector
    if kind == "tpf":
        assert all(r.cuda_launches == r.live_slots == 0 for r in recs)
    else:
        assert sum(r.cuda_launches for r in recs) \
            == sel.grouped_chunks + sel.fused_chunks > 0
        assert all(0 < r.live_slots <= r.pats for r in recs if r.cand)


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_traces_count_cuda_launches(datasets, monkeypatch, shards):
    """The sharded backend with 16-row windows and the chunk cap forced to
    two pages (as ``TestChunkedPlans`` in test_torch_federation.py): the
    traces' CUDA launches sum to the selector's grouped and fused chunks,
    fewer than the LaunchRecords, and a record's live slots are one
    group's per LaunchRecord."""
    import repro_torch.core.federation as tfed
    _, tdata = datasets
    window = 16
    monkeypatch.setattr(tfed, "MAX_CHUNK_ROWS", 2 * shards * window)
    srv = tcore.BrTPFServer(tdata.store, tcore.ServerConfig(
        selector_backend="sharded", shards=shards, shard_window=window,
        device="cpu"))
    recs = records(tsim.collect_traces(srv, workload(twatdiv, tdata)[:2],
                                       "brtpf", request_budget=40))
    sel = srv._selector
    kernel = [r for r in recs if r.cand > 0]
    assert sum(r.cuda_launches for r in recs) \
        == sel.grouped_chunks + sel.fused_chunks
    assert sum(r.launches for r in kernel) \
        > sum(r.cuda_launches for r in kernel) > 0
    for r in kernel:
        assert 1 <= r.cuda_launches <= r.launches
        per_record, rest = divmod(r.live_slots, r.launches)
        assert rest == 0 and 0 < per_record <= r.pats // r.launches
        assert len(r.shard_pages) == shards
    assert all(r.cuda_launches == r.live_slots == 0 for r in recs
               if r.cand == 0)


def synthetic_trace():
    """Three records by hand: a numpy-backend request, a kernel-backend
    one (one launch, 5 of 128 slots live) and a sharded one (8 window
    pages of 256 rows in one CUDA launch, 3 of 128 slots live)."""
    V = tcore.encode_var
    keys = [tcore.Request(tcore.TriplePattern(V(0), p, V(1)), None,
                          0).key() for p in (3, 5, 7)]
    return [
        tsim.HttpRecord(key=keys[0], lookups=2, scanned=50, recv=40),
        tsim.HttpRecord(key=keys[1], lookups=1, scanned=30, recv=20,
                        pattern_key=keys[1][0], cand=2048, pats=128,
                        launches=1, cand_rows=1500, live_slots=5,
                        cuda_launches=1),
        tsim.HttpRecord(key=keys[2], lookups=1, scanned=10, recv=10,
                        pattern_key=keys[2][0], cand=8 * 256,
                        pats=8 * 128, launches=8, live_slots=8 * 3,
                        cuda_launches=1, shard_pages=(8,))]


def test_kernel_charge_of_a_synthetic_trace():
    """The charge of each record and the replayed query time, by hand,
    under the CUDA accounting and (the two fields zeroed) the JAX
    package's, which the reference simulator gives too."""
    p = tsim.SimParams(kernel_launch_overhead_s=5e-5, kernel_cell_s=1e-12,
                       kernel_stream_s=1e-11, req_overhead_s=1e-3,
                       pipeline_depth=1, net_latency_s=1e-3,
                       client_overhead_s=2e-4, lookup_s=2e-4,
                       scan_s_per_triple=1.5e-6, bytes_per_triple=120.0,
                       bandwidth_bps=1.25e9)
    cuda = synthetic_trace()
    ref = [dataclasses.replace(ev, live_slots=0, cuda_launches=0)
           for ev in cuda]
    o, s, c, r = (p.kernel_launch_overhead_s, p.kernel_stream_s,
                  p.kernel_cell_s, p.req_overhead_s)
    charges = {
        "cuda": [(o, 2048 * s, r + 2048 * 5 * c),
                 (o, 2048 * s, r + 2048 * 3 * c)],
        "ref": [(o, 2048 * s, r + 2048 * 128 * c),
                (8 * o, 2048 * s, r + 2048 * 128 * c)]}
    numpy_s = r + 2 * p.lookup_s + 50 * p.scan_s_per_triple
    for name, trace in (("cuda", cuda), ("ref", ref)):
        got = [tsim.kernel_charge(ev, p) for ev in trace[1:]]
        assert got == pytest.approx(charges[name], rel=1e-12, abs=0)
        # one query of the three records, one client, nothing batched:
        # each record's latency, service, transfer and client overhead
        want = sum(2 * p.net_latency_s + ev.recv * p.bytes_per_triple
                   / p.bandwidth_bps + p.client_overhead_s
                   for ev in trace) + numpy_s + sum(map(sum,
                                                        charges[name]))
        res = tsim.simulate([[tsim.QueryTrace("q", trace, True)]], p)
        assert (res.completed, res.launches, res.kernel_requests) \
            == (1, 9, 2)
        assert res.qets == pytest.approx([want], rel=1e-12, abs=0)
    jp = jsim.SimParams(**dataclasses.asdict(p))
    jrec = [jsim.HttpRecord(**{k: getattr(ev, k) for k in REF_FIELDS})
            for ev in ref]
    want = jsim.simulate([[jsim.QueryTrace("q", jrec, True)]], jp)
    got = tsim.simulate([[tsim.QueryTrace("q", ref, True)]], p)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("backend", ["kernel", "sharded"])
def test_cuda_charge_never_exceeds_reference(kernel_traces, datasets,
                                             backend):
    """Per kernel-path record of the port's traces: the CUDA charge's
    overhead and cells are at most the JAX package's, its stream equal."""
    if backend == "kernel":
        ttr = kernel_traces[1]
    else:
        _, tdata = datasets
        srv = tcore.BrTPFServer(tdata.store, tcore.ServerConfig(
            selector_backend="sharded", shards=4, shard_window=64,
            device="cpu"))
        ttr = tsim.collect_traces(srv, workload(twatdiv, tdata)[:2],
                                  "brtpf", request_budget=40)
    p = tsim.SimParams(**TEST_PROFILE)
    kernel = [r for r in records(ttr) if r.cand > 0]
    assert kernel
    for ev in kernel:
        got = tsim.kernel_charge(ev, p)
        ref = tsim.kernel_charge(
            dataclasses.replace(ev, live_slots=0, cuda_launches=0), p)
        assert got[0] <= ref[0] and got[1] == ref[1] and got[2] <= ref[2]
    assert any(tsim.kernel_charge(ev, p)[2] < tsim.kernel_charge(
        dataclasses.replace(ev, live_slots=0, cuda_launches=0), p)[2]
        for ev in kernel)


@pytest.mark.parametrize("names", [("C1", "C1"), ("C1", "C1b")])
def test_memo_owner_is_the_query_name(names):
    """The raw-row gap of the live replay, in both packages: two queries
    whose traces each launched the same fragment (cand > 0). Under one
    name the model takes the second for a repeat execution of the first
    and skips it, where the live server launches it; under two names
    both launch."""
    V = tcore.encode_var
    key = tcore.Request(tcore.TriplePattern(V(0), 3, V(1)), None,
                        0).key()
    rec = dict(key=key, lookups=1, scanned=100, recv=100,
               pattern_key=key[0], cand=1024, pats=128, launches=1,
               cand_rows=900, cand_full_rows=900)
    got = tsim.simulate([[tsim.QueryTrace(n, [tsim.HttpRecord(**rec)],
                                          True) for n in names]],
                        tsim.SimParams(**TEST_PROFILE))
    want = jsim.simulate([[jsim.QueryTrace(n, [jsim.HttpRecord(**rec)],
                                           True) for n in names]],
                         jsim.SimParams(**TEST_PROFILE))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    same = names[0] == names[1]
    assert (got.launches, got.launches_skipped, got.cand_rows) \
        == ((1, 1, 900) if same else (2, 0, 1800))


@pytest.mark.parametrize("clients", [1, 4, 16])
@pytest.mark.parametrize("params", [
    dict(),
    dict(batch_window_s=2e-3),
    dict(batch_window_s=2e-3, fuse_patterns=False),
    dict(batch_window_s=5e-3, server_workers=1, selector_memo_entries=4),
    dict(pipeline_depth=1, duration_s=2.0, wrap=True),
], ids=["unbatched", "fused", "unfused", "one-worker", "wrapped"])
def test_simulate_equals_reference(kernel_traces, clients, params):
    jtr, _ = kernel_traces
    params = dict(params)
    wrap = params.pop("wrap", False)
    jp = jsim.SimParams(**TEST_PROFILE, **params)
    tp = tsim.SimParams(**dataclasses.asdict(jp))
    want = jsim.simulate(jsim.split_workload(jtr, clients), jp, wrap=wrap)
    got = tsim.simulate(tsim.split_workload(as_port(jtr), clients), tp,
                        wrap=wrap)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.launches > 0 and got.kernel_requests > 0
    assert (got.launches_per_request, got.cand_per_request,
            got.throughput_per_hour, got.avg_qet) \
        == (want.launches_per_request, want.cand_per_request,
            want.throughput_per_hour, want.avg_qet)


@pytest.mark.parametrize("cache_size", [8, 64])
def test_simulate_with_shared_cache_equals_reference(kernel_traces,
                                                     cache_size):
    jtr, _ = kernel_traces
    jp = jsim.SimParams(**TEST_PROFILE, batch_window_s=1e-3)
    tp = tsim.SimParams(**dataclasses.asdict(jp))
    want = jsim.simulate(jsim.split_workload(jtr, 4), jp,
                         cache_size=cache_size, use_cache=True)
    got = tsim.simulate(tsim.split_workload(as_port(jtr), 4), tp,
                        cache_size=cache_size, use_cache=True)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("n,clients", [(8, 16), (8, 3), (16, 16), (5, 2)])
def test_split_workload_equals_reference(n, clients):
    items = list(range(n))
    assert tsim.split_workload(items, clients) \
        == jsim.split_workload(items, clients)


def test_requests_from_trace_equal_reference(kernel_traces):
    jtr, ttr = kernel_traces
    for jt, tt in zip(jtr, ttr, strict=True):
        got = tsim.requests_from_trace(tt)
        assert all(isinstance(r, tcore.Request) for r in got)
        assert [r.key() for r in got] \
            == [r.key() for r in jsim.requests_from_trace(jt)]


def test_live_validation_properties_equal_reference():
    kw = dict(simulated_launches=20, observed_launches=18, requests=50,
              observed_batched=30, flushes=9, simulated_skipped=4,
              observed_skipped=5, simulated_cand=1000, observed_cand=1100,
              simulated_cand_rows=700, observed_cand_rows=700,
              simulated_shard=(3, 4), observed_shard=(3, 5, 1))
    got, want = tsim.LiveValidation(**kw), jsim.LiveValidation(**kw)
    for prop in ("agreement", "within", "skip_within", "cand_within",
                 "cand_rows_within", "shard_within"):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_live_launches_agree_with_sim_within_10pct():
    """The JAX package's case (tests/test_batching.py): 16 clients, two
    same-pattern waves, one grouped launch per wave."""
    rng = np.random.default_rng(13)
    arr = rng.integers(0, 15, size=(600, 3)).astype(np.int32)
    V = tcore.encode_var
    tp_a = tcore.TriplePattern(V(0), 3, V(1))
    tp_b = tcore.TriplePattern(V(0), 5, V(1))
    rng = np.random.default_rng(13)

    def omega():
        om = rng.integers(0, 15, size=(4, 2)).astype(np.int32)
        om[rng.random((4, 2)) < 0.3] = tcore.UNBOUND
        return om

    def rec(tp, om):
        return tsim.HttpRecord(key=tcore.Request(tp, om, 0).key(),
                               lookups=1, scanned=10, recv=5,
                               pattern_key=tp.as_tuple(), cand=1024, pats=8)

    traces_per_client = [
        [tsim.QueryTrace(f"q{ci}", [rec(tp_a, omega()), rec(tp_b, omega())],
                         completed=True)]
        for ci in range(16)]
    server = tcore.BrTPFServer(tcore.TripleStore(arr), tcore.ServerConfig(
        selector_backend="kernel", device="cpu"))
    lv = tsim.live_replay(traces_per_client, server,
                          tsim.SimParams(**TEST_PROFILE),
                          batch_window_s=5e-3)
    assert lv.requests == 32
    assert lv.simulated_launches == 2
    assert lv.within <= 0.10
    assert lv.observed_launches < 32
    assert lv.observed_shed == 0


def test_live_replay_of_watdiv_traces(kernel_traces, datasets):
    """The port's own traces replayed by 4 clients through a 2 ms
    batching window (the shape of chip_smoke.py's sim phase)."""
    _, tdata = datasets
    _, ttr = kernel_traces
    server = tcore.BrTPFServer(tdata.store, tcore.ServerConfig(
        selector_backend="kernel", device="cpu"))
    lv = tsim.live_replay(tsim.split_workload(ttr, 4), server,
                          tsim.SimParams(**TEST_PROFILE),
                          batch_window_s=2e-3)
    assert lv.requests == sum(
        isinstance(ev, tsim.HttpRecord) for t in ttr for ev in t.events)
    assert lv.within <= 0.10
    assert lv.observed_shed == 0
    assert lv.cand_rows_within <= 0.10


def test_sim_params_carry_no_tpu_constant():
    port, ref = tsim.SimParams(), jsim.SimParams()
    for name in KERNEL_FIELDS:
        assert getattr(port, name) > 0, name
        assert getattr(port, name) != getattr(ref, name), name
    # everything else is the JAX package's model, unchanged
    rest = {f.name for f in dataclasses.fields(ref)} - set(KERNEL_FIELDS)
    assert {k: getattr(port, k) for k in rest} \
        == {k: getattr(ref, k) for k in rest}


@pytest.mark.parametrize("device", [None, "cpu"])
def test_calibrate_kernels_needs_the_card(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.calibrate_kernels(device)


def test_main_on_the_cpu(capsys):
    assert tsim.main(["--device", "cpu", "--clients", "4", "--queries",
                      "4", "--live"]) == 0
    out = capsys.readouterr().out
    assert "validation: simulated=" in out
    assert "kernel profile" not in out
    assert "sim (the JAX package's kernel accounting): throughput" in out


def test_smoke_profile_completeness():
    """What chip_smoke.py's sim phase finds a profile lost: each host
    call that issues device work and has no device record (matched by
    correlation id), by name, and each such kernel launch's place from
    the last; host calls that issue no device work are not counted."""
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, device, corr, start_ns):
        return SimpleNamespace(name=lambda: name, device_type=lambda: device,
                               correlation_id=lambda: corr,
                               start_ns=lambda: start_ns)

    host = [ev("cudaLaunchKernel", cpu, 1, 1000),
            ev("cudaMemcpyAsync", cpu, 2, 2000),
            ev("cudaStreamSynchronize", cpu, 3, 3000),
            ev("cuLaunchKernel", cpu, 4, 4000)]
    device = [ev("bindjoin_grouped_kernel", cuda, 1, 1500),
              ev("Memcpy HtoD (Pageable -> Device)", cuda, 2, 2500),
              ev("bindjoin_fused_kernel", cuda, 4, 4500)]

    def prof(events):
        return SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events)))

    def lost(events):
        return smoke.lost_device_records(torch, prof(events))

    assert lost(host + device) == dict(calls={}, launches=0, of=2,
                                       from_end=[], early_ms=0.0)
    assert lost(host + device[:2]) == dict(
        calls={"cuLaunchKernel": 1}, launches=1, of=2, from_end=[1],
        early_ms=0.0)
    assert lost(host) == dict(
        calls={"cudaLaunchKernel": 1, "cudaMemcpyAsync": 1,
               "cuLaunchKernel": 1}, launches=2, of=2, from_end=[2, 1],
        early_ms=0.0)
    # a device record the profiler's clock put 2.5 us before its call
    early = ev("bindjoin_fused_kernel", cuda, 4, 1500)
    assert lost(host + device[:2] + [early])["early_ms"] == 0.0025
