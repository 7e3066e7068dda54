"""The port's trace-replay simulator against the JAX package's, on the CPU.

* ``collect_traces`` records the same per-request events on both
  packages' servers (kernel backend, and the sharded backend at one
  shard): keys, rows scanned and received, candidate rows streamed,
  pattern slots and launches;
* the same traces through both packages' ``simulate`` with the same
  ``SimParams`` give equal ``SimResult``s, with and without batching,
  fusion and the shared cache;
* ``live_replay`` agrees with the live async front end within the JAX
  package's 10% bound (``tests/test_batching.py``'s case, and the port's
  own traces of a WatDiv-like workload);
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


def events(traces):
    return [(t.name, t.completed, [
        dataclasses.asdict(ev) if dataclasses.is_dataclass(ev) else ev
        for ev in t.events]) for t in traces]


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
    recs = [ev for t in ttr for ev in t.events
            if isinstance(ev, tsim.HttpRecord)]
    assert sum(r.launches for r in recs) > 0
    assert sum(r.cand for r in recs) > 0


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
