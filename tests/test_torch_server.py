"""The port's serving slice against the JAX package's, end to end.

Both packages serve the same WatDiv-like store (the port's built from
the JAX package's arrays through ``repro_torch.data.watdiv.from_arrays``)
with the kernel backend: the JAX server with its Pallas kernels in
interpret mode, the port's with ``device="cpu"``. Queries go through the
sequential brTPF client, the concurrent async client and
``serve_concurrent`` with heterogeneous windows (the fused path).
Solutions, request counts, transfer and the launch counters must agree.
"""
import asyncio
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.data.watdiv as jwatdiv
import repro_torch.core as tcore
import repro_torch.data.watdiv as twatdiv

pytestmark = pytest.mark.tier1

SCALE = dict(users=120, products=60, reviews=180, retailers=6, genres=8,
             cities=10, tags=12)
FAMILIES = ("L", "S", "F", "C")


@pytest.fixture(scope="module")
def datasets():
    return datasets_once()


def datasets_once():
    jdata = jwatdiv.generate(jwatdiv.WatDivScale(**SCALE), seed=3)
    terms = [jdata.dictionary.term(i) for i in range(len(jdata.dictionary))]
    tdict, tstore = twatdiv.from_arrays(jdata.store.triples, terms)
    tdata = twatdiv.WatDivData(tdict, tstore, twatdiv.WatDivScale(**SCALE))
    return jdata, tdata


def pick_queries(data, watdiv, per_family=1, seed=1):
    """The first ``per_family`` queries of each template family."""
    out, seen = [], {}
    for name, bgp in watdiv.generate_workload(data, 60, seed=seed):
        if seen.get(name[0], 0) < per_family:
            seen[name[0]] = seen.get(name[0], 0) + 1
            out.append((name, bgp))
    assert set(seen) == set(FAMILIES)
    return out


def make_servers(datasets, **cfg):
    jdata, tdata = datasets
    jsrv = jcore.BrTPFServer(jdata.store, jcore.ServerConfig(
        selector_backend="kernel", **cfg))
    tsrv = tcore.BrTPFServer(tdata.store, tcore.ServerConfig(
        selector_backend="kernel", device="cpu", **cfg))
    return jsrv, tsrv


def counters(server):
    return dataclasses.asdict(server.counters)


def test_generate_matches_reference():
    scale = dict(SCALE, users=90)
    jdata = jwatdiv.generate(jwatdiv.WatDivScale(**scale), seed=5)
    tdata = twatdiv.generate(twatdiv.WatDivScale(**scale), seed=5)
    np.testing.assert_array_equal(tdata.store.triples, jdata.store.triples)
    assert len(tdata.dictionary) == len(jdata.dictionary)
    assert all(tdata.dictionary.term(i) == jdata.dictionary.term(i)
               for i in range(len(jdata.dictionary)))
    jq = jwatdiv.generate_workload(jdata, 20, seed=2)
    tq = twatdiv.generate_workload(tdata, 20, seed=2)
    assert [(n, [p.as_tuple() for p in b.patterns]) for n, b in tq] \
        == [(n, [p.as_tuple() for p in b.patterns]) for n, b in jq]


def test_from_arrays_carries_the_store(datasets):
    jdata, tdata = datasets
    np.testing.assert_array_equal(tdata.store.triples, jdata.store.triples)
    assert tdata.dictionary.lookup("likes") \
        == jdata.dictionary.lookup("likes")
    with pytest.raises(ValueError, match="distinct"):
        twatdiv.from_arrays(jdata.store.triples[:2], ["a", "a"])


def test_brtpf_client_matches_reference(datasets):
    jdata, tdata = datasets
    jsrv, tsrv = make_servers(datasets, page_size=50, max_mpr=20)
    jq = pick_queries(jdata, jwatdiv)
    tq = pick_queries(tdata, twatdiv)
    for (jname, jbgp), (tname, tbgp) in zip(jq, tq, strict=True):
        assert jname == tname
        want = jcore.BrTPFClient(jsrv, request_budget=150).execute(jbgp)
        got = tcore.BrTPFClient(tsrv, request_budget=150).execute(tbgp)
        np.testing.assert_array_equal(got.solutions, want.solutions)
        assert (got.num_requests, got.data_received, got.timed_out) \
            == (want.num_requests, want.data_received, want.timed_out)
    assert tsrv.counters.kernel_launches > 0
    assert counters(tsrv) == counters(jsrv)
    assert tsrv.metrics_snapshot() == jsrv.metrics_snapshot()


def test_serve_concurrent_fused_windows_match_reference(datasets):
    """Equal-length heterogeneous streams with max_batch = #streams:
    every window flushes full, so the batches (and the counters) are
    the same on both sides, and heterogeneous windows fuse."""
    jdata, tdata = datasets
    d = jdata.dictionary
    v = jcore.encode_var
    rng = np.random.default_rng(9)
    shapes = [(v(0), d.lookup("likes"), v(1)),
              (v(0), d.lookup("hasGenre"), v(1)),
              (v(0), d.lookup("livesIn"), d.lookup("city3")),
              (v(0), d.lookup("reviewsProduct"), v(1))]
    users = [d.lookup(f"user{i}") for i in range(SCALE["users"])]
    prods = [d.lookup(f"product{i}") for i in range(SCALE["products"])]

    def omega_for(i):
        if i == 0:
            return np.array([[u, -1] for u in rng.choice(users, 7)],
                            np.int32)
        if i == 1:
            return np.array([[p, -1] for p in rng.choice(prods, 5)],
                            np.int32)
        if i == 3:
            return np.array([[-1, p] for p in rng.choice(prods, 4)],
                            np.int32)
        return None

    plan = [[(i, omega_for(i), count) for count in (False, True)]
            for i in range(len(shapes))]

    def streams(pkg):
        return [[pkg.Request(pkg.TriplePattern(*shapes[i]), om,
                             count_only=count) for i, om, count in s]
                for s in plan]

    jsrv, tsrv = make_servers(datasets, page_size=40)
    jres, jfront = jcore.serve_concurrent(
        jsrv, streams(jcore), batch_window_s=5.0, max_batch=len(plan))
    tres, tfront = tcore.serve_concurrent(
        tsrv, streams(tcore), batch_window_s=5.0, max_batch=len(plan))
    for js, ts in zip(jres, tres, strict=True):
        for jf, tf in zip(js, ts, strict=True):
            assert tf.data.tobytes() == jf.data.tobytes()
            assert (tf.cnt, tf.has_next, tf.page, tf.triples_received) \
                == (jf.cnt, jf.has_next, jf.page, jf.triples_received)
    assert tsrv.counters.fused_launches >= 1
    assert counters(tsrv) == counters(jsrv)
    assert dataclasses.asdict(tfront.stats) == dataclasses.asdict(
        jfront.stats)


def test_async_clients_match_reference(datasets):
    """Four concurrent async clients, one query each, over the batching
    front end: solutions and per-client accounting equal the reference
    and the port's numpy oracle. Which requests share a window depends
    on timing, so only window-independent server counters are compared
    across packages."""
    jdata, tdata = datasets
    jq = [b for _, b in pick_queries(jdata, jwatdiv)]
    tq = [b for _, b in pick_queries(tdata, twatdiv)]

    def run(pkg, server, bgps):
        front = pkg.AsyncBrTPFServer(server, batch_window_s=0.05)

        async def main():
            try:
                clients = [pkg.AsyncBrTPFClient(front, request_budget=150)
                           for _ in bgps]
                return await asyncio.gather(*[
                    c.execute(b) for c, b in zip(clients, bgps,
                                                 strict=True)])
            finally:
                await front.aclose()

        return asyncio.run(main())

    jsrv, tsrv = make_servers(datasets, page_size=50, max_mpr=20)
    oracle = tcore.BrTPFServer(tdata.store, tcore.ServerConfig(
        page_size=50, max_mpr=20))
    want = run(jcore, jsrv, jq)
    got = run(tcore, tsrv, tq)
    ref = run(tcore, oracle, tq)
    for w, g, r in zip(want, got, ref, strict=True):
        np.testing.assert_array_equal(g.solutions, w.solutions)
        np.testing.assert_array_equal(g.solutions, r.solutions)
        assert (g.num_requests, g.data_received, g.timed_out) \
            == (w.num_requests, w.data_received, w.timed_out)
    invariant = ("num_requests", "data_received", "data_triples",
                 "meta_triples", "mappings_sent")
    tc, jc = counters(tsrv), counters(jsrv)
    assert {k: tc[k] for k in invariant} == {k: jc[k] for k in invariant}
    assert tsrv.counters.fused_launches >= 1


def test_sharded_backend_matches_reference():
    """The sharded backend's server equals the reference's on the slice
    (solutions, request counts and transfer), and its config is
    accepted with the JAX package's defaults."""
    cfg = tcore.ServerConfig(selector_backend="sharded", device="cpu",
                             shards=2)
    assert cfg.selector_backend == "sharded"
    assert cfg.shard_window is None and cfg.placement_policy == "static"
    jdata, tdata = datasets_once()
    jq = pick_queries(jdata, jwatdiv)[:2]
    tq = pick_queries(tdata, twatdiv)[:2]
    jsrv = jcore.BrTPFServer(jdata.store, jcore.ServerConfig(
        selector_backend="sharded", page_size=50))
    tsrv = tcore.BrTPFServer(tdata.store, cfg.replace(page_size=50))
    for (_, jb), (_, tb) in zip(jq, tq, strict=True):
        want = jcore.BrTPFClient(jsrv, request_budget=40).execute(jb)
        got = tcore.BrTPFClient(tsrv, request_budget=40).execute(tb)
        np.testing.assert_array_equal(got.solutions, want.solutions)
        assert (got.num_requests, got.data_received, got.timed_out) \
            == (want.num_requests, want.data_received, want.timed_out)
