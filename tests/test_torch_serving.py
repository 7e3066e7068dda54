"""The port's serving edge against the JAX package's, on the CPU.

Both packages serve the same small store: the JAX package as its own
tests run it (Pallas in interpret mode), the port with ``device="cpu"``
(the kernels' plain PyTorch versions). The contract under test:

* brtpf/v1 bodies (requests, fragments, errors) are byte-identical
  across the two packages, a body written by one is read by the other,
  and both reject the same malformed bodies;
* ``ServerConfig`` crosses the wire in both directions (shared fields
  equal, ``device`` host-local, unknown keys dropped);
* the port's ASGI app, loopback and ASGI transports serve fragments
  byte-identical to the JAX package's app on the numpy and kernel
  backends, and on the sharded backend at 1 and 4 logical shards; the
  414/400/404/405/503/504 mappings match;
* the replica router pins and spreads requests as the JAX package's
  does, and its merged snapshot has the same schema and numbers;
* seeded fault plans and retry jitter draw the same numbers as the JAX
  package's; breakers, retries, hedges and deadlines behave the same;
* a small chaos run (the JAX package's plan: seed 1608, 5% errors on
  every replica, replica 1 stalled) keeps a success rate >= 0.999 with
  parity to a fault-free oracle in both packages, and its bare A/B arm
  fails at least one query.
"""
import asyncio
import dataclasses
import json
import time

import numpy as np
import pytest

import repro.core as jcore
import repro.core.metrics as jmetrics
import repro.core.sim as jsim
import repro.core.wire as jwire
import repro.serving.faults as jfaults
import repro.serving.http as jhttp
import repro.serving.resilience as jres
import repro.serving.router as jrouter
import repro.serving.transport as jtransport
import repro_torch.core as tcore
import repro_torch.core.metrics as tmetrics
import repro_torch.core.sim as tsim
import repro_torch.core.wire as twire
import repro_torch.serving.faults as tfaults
import repro_torch.serving.http as thttp
import repro_torch.serving.resilience as tres
import repro_torch.serving.router as trouter
import repro_torch.serving.transport as ttransport

pytestmark = pytest.mark.tier1


@dataclasses.dataclass(frozen=True)
class Pkg:
    """One package's serving stack, addressed the same way for both."""
    name: str
    core: object
    metrics: object
    wire: object
    http: object
    transport: object
    faults: object
    res: object
    router: object
    sim: object

    def config(self, **kw):
        if self.name == "torch":
            kw.setdefault("device", "cpu")
        else:
            kw.pop("shards", None)
        return self.core.ServerConfig(**kw)


JAX = Pkg("jax", jcore, jmetrics, jwire, jhttp, jtransport,
          jfaults, jres, jrouter, jsim)
TORCH = Pkg("torch", tcore, tmetrics, twire, thttp, ttransport,
            tfaults, tres, trouter, tsim)
PKGS = (JAX, TORCH)


def store_array(seed=0, n=600, terms=18):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, terms, size=(n, 3)).astype(np.int32),
                     axis=0)


def rand_omega(rng, m, v=2, terms=18, unbound_frac=0.3):
    om = rng.integers(0, terms, size=(m, v)).astype(np.int32)
    om[rng.random((m, v)) < unbound_frac] = jcore.UNBOUND
    return om


def sample_requests(pkg, arr, seed=3, count=24, max_mpr=30):
    """Mixed TPF/brTPF page requests whose patterns occur in the store;
    the same draws for either package."""
    rng = np.random.default_rng(seed)
    V = pkg.core.encode_var
    reqs = []
    for i in range(count):
        s, p, o = (int(x) for x in arr[rng.integers(len(arr))])
        shape = i % 4
        tp = [(V(0), p, o), (s, p, V(0)), (V(0), p, V(1)),
              (V(0), V(1), o)][shape]
        tp = pkg.core.TriplePattern(*tp)
        omega = None
        if i % 3:
            omega = rand_omega(rng, int(rng.integers(1, max_mpr)),
                               v=len(tp.variables()))
        reqs.append(pkg.core.Request(pattern=tp, omega=omega, page=0))
    return reqs


def small_workload(pkg):
    V = pkg.core.encode_var
    b = pkg.core.bgp_from_arrays
    return [("q1", b([[V(0), 2, V(1)], [V(1), 3, V(2)]])),
            ("q2", b([[V(0), 1, V(1)], [V(0), 4, V(2)]])),
            ("q3", b([[V(0), 5, 7]]))]


def canon(solutions):
    arr = np.asarray(solutions)
    if arr.size == 0:
        return arr.reshape(0, arr.shape[1] if arr.ndim == 2 else 0)
    return arr[np.lexsort(arr.T[::-1])]


def frag_bytes(pkg, frag):
    return pkg.wire.dumps(pkg.wire.fragment_to_wire(frag))


# ---------------------------------------------------------------------------
# Wire schema
# ---------------------------------------------------------------------------


def wire_requests(pkg):
    """Requests covering every optional field of the request envelope."""
    rng = np.random.default_rng(0)
    V, TP, R = pkg.core.encode_var, pkg.core.TriplePattern, pkg.core.Request
    return [
        R(pattern=TP(5, V(0), V(1))),
        R(pattern=TP(V(0), 3, V(1)), omega=rand_omega(rng, 7), page=2),
        R(pattern=TP(V(0), 2, 9), omega=rand_omega(rng, 5, v=1), page=1),
        R(pattern=TP(V(0), 2, 3), timeout_ms=250.0),
        R(pattern=TP(V(0), 2, V(1)), omega=np.zeros((0, 2), np.int32),
          count_only=True),
        R(pattern=TP(1, 2, 3), count_only=True, timeout_ms=12.5, page=4),
    ]


class TestWire:
    @pytest.mark.parametrize("i", range(6))
    def test_request_bytes_equal_across_packages(self, i):
        jreq, treq = wire_requests(JAX)[i], wire_requests(TORCH)[i]
        jb = jwire.dumps(jwire.request_to_wire(jreq))
        tb = twire.dumps(treq.to_wire())
        assert tb == jb
        # a body written by one package is read by the other
        back = tcore.Request.from_wire(twire.loads(jb))
        assert isinstance(back, tcore.Request)
        assert twire.dumps(twire.request_to_wire(back)) == jb
        assert back.key() == treq.key()
        assert back.timeout_ms == treq.timeout_ms
        jback = jwire.request_from_wire(jwire.loads(tb))
        assert jwire.dumps(jback.to_wire()) == tb

    def test_request_round_trip(self):
        req = wire_requests(TORCH)[1]
        out = twire.request_from_wire(twire.loads(twire.dumps(
            req.to_wire())))
        assert out.pattern == req.pattern and out.page == req.page
        assert out.omega.dtype == np.int32
        assert np.array_equal(out.omega, req.omega)
        assert out.key() == req.key()
        env = req.to_wire()
        assert env["v"] == twire.WIRE_VERSION == jwire.WIRE_VERSION
        assert env["kind"] == "request"
        # optional fields are emitted only when set
        assert "timeout_ms" not in env and "count_only" not in env
        # the deadline is delivery metadata, not cache identity
        timed = wire_requests(TORCH)[3]
        assert twire.request_from_wire(timed.to_wire()).key() \
            == tcore.Request(pattern=timed.pattern).key()

    @pytest.mark.parametrize("mutate", [
        lambda e: e.update(v="brtpf/v0"),
        lambda e: e.update(v=None),
        lambda e: e.update(kind="fragment"),
        lambda e: e.update(pattern=[1, 2]),
        lambda e: e.update(pattern="spo"),
        lambda e: e.update(page=-1),
        lambda e: e.update(page="0"),
        lambda e: e.update(omega=[[1, 2], [3]]),
        lambda e: e.update(omega=42),
        lambda e: e.update(count_only="yes"),
        lambda e: e.update(timeout_ms=0),
        lambda e: e.update(timeout_ms=-5),
        lambda e: e.update(timeout_ms="100"),
        lambda e: e.update(timeout_ms=True),
        lambda e: e.update(timeout_ms=[100]),
    ])
    def test_malformed_request_rejected_by_both(self, mutate):
        for pkg in PKGS:
            env = pkg.wire.request_to_wire(pkg.core.Request(
                pattern=pkg.core.TriplePattern(pkg.core.encode_var(0), 2, 3),
                omega=np.zeros((2, 1), dtype=np.int32)))
            mutate(env)
            with pytest.raises(pkg.wire.WireError):
                pkg.wire.request_from_wire(env)

    @pytest.mark.parametrize("raw", [b"{not json", b"[1,2,3]", b"\xff"])
    def test_invalid_json_rejected(self, raw):
        with pytest.raises(twire.WireError):
            twire.loads(raw)

    @pytest.mark.parametrize("backend", ["numpy", "kernel"])
    def test_fragment_bytes_equal_across_packages(self, backend):
        arr = store_array()
        frags = {}
        for pkg in PKGS:
            server = pkg.core.BrTPFServer(pkg.core.TripleStore(arr),
                                          pkg.config(page_size=20,
                                                     selector_backend=backend))
            frags[pkg.name] = [server.handle(r) for r in
                               sample_requests(pkg, arr, count=6)]
        for jf, tf in zip(frags["jax"], frags["torch"], strict=True):
            once = frag_bytes(TORCH, tf)
            assert once == frag_bytes(JAX, jf)
            out = twire.fragment_from_wire(twire.loads(once))
            assert out.data.dtype == np.int32
            assert np.array_equal(out.data, np.asarray(tf.data))
            assert (out.cnt, out.page, out.page_size, out.has_next,
                    out.meta_triples) == (tf.cnt, tf.page, tf.page_size,
                                          tf.has_next, tf.meta_triples)
            assert frag_bytes(TORCH, out) == once
            # the reference reads the port's body back to the same bytes
            assert frag_bytes(JAX, jwire.fragment_from_wire(
                jwire.loads(once))) == once

    @pytest.mark.parametrize("field", ["cnt", "page", "data", "has_next"])
    def test_fragment_missing_field_rejected(self, field):
        server = tcore.BrTPFServer(tcore.TripleStore(store_array()))
        env = twire.fragment_to_wire(server.handle(tcore.Request(
            pattern=tcore.TriplePattern(tcore.encode_var(0), 2,
                                        tcore.encode_var(1)))))
        del env[field]
        with pytest.raises(twire.WireError):
            twire.fragment_from_wire(env)


class TestErrorEnvelope:
    @pytest.mark.parametrize("code", list(jwire.ERROR_CODES))
    def test_every_code_round_trips_with_equal_bytes(self, code):
        assert twire.ERROR_CODES == jwire.ERROR_CODES
        env = twire.error_to_wire(503, "busy", retryable=True, code=code,
                                  retry_after_ms=12.5)
        once = twire.dumps(env)
        assert once == jwire.dumps(jwire.error_to_wire(
            503, "busy", retryable=True, code=code, retry_after_ms=12.5))
        out = twire.error_from_wire(twire.loads(once))
        assert out == {"status": 503, "error": "busy", "retryable": True,
                       "code": code, "retry_after_ms": 12.5}
        again = twire.dumps(twire.error_to_wire(
            out["status"], out["error"], retryable=out["retryable"],
            code=out["code"], retry_after_ms=out["retry_after_ms"]))
        assert again == once
        assert jwire.error_from_wire(jwire.loads(once)) == out

    def test_optional_fields_emitted_only_when_set(self):
        env = twire.error_to_wire(400, "bad request")
        assert "code" not in env and "retry_after_ms" not in env
        assert "retryable" not in env
        assert twire.dumps(env) == jwire.dumps(
            jwire.error_to_wire(400, "bad request"))
        out = twire.error_from_wire(twire.loads(twire.dumps(env)))
        assert (out["code"], out["retry_after_ms"], out["retryable"]) \
            == (None, None, False)

    def test_unknown_code_rejected_at_encode(self):
        with pytest.raises(ValueError):
            twire.error_to_wire(500, "boom", code="EXPLODED")

    @pytest.mark.parametrize("mutate", [
        lambda e: e.update(kind="fragment"),
        lambda e: e.update(status="503"),
        lambda e: e.update(status=True),
        lambda e: e.pop("error"),
        lambda e: e.update(code="NOT_A_CODE"),
        lambda e: e.update(retryable="yes"),
        lambda e: e.update(retry_after_ms=-1),
    ])
    def test_malformed_error_rejected_by_both(self, mutate):
        for pkg in PKGS:
            env = pkg.wire.error_to_wire(503, "busy", retryable=True,
                                         code="QUEUE_SATURATED",
                                         retry_after_ms=5.0)
            mutate(env)
            with pytest.raises(pkg.wire.WireError):
                pkg.wire.error_from_wire(env)


try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False


if HAVE_HYPOTHESIS:
    @st.composite
    def request_fields(draw):
        comps, nvars = [], 0
        for _ in range(3):
            if draw(st.booleans()):
                comps.append(-(nvars + 1))
                nvars += 1
            else:
                comps.append(draw(st.integers(0, 8)))
        omega = None
        if nvars and draw(st.booleans()):
            m = draw(st.integers(0, 6))
            rows = draw(st.lists(st.tuples(*[st.integers(-1, 9)] * nvars),
                                 min_size=m, max_size=m))
            omega = np.asarray(rows, dtype=np.int32).reshape(m, nvars)
            omega[omega < 0] = jcore.UNBOUND
        timeout_ms = draw(st.one_of(st.none(), st.floats(
            min_value=0.5, max_value=60_000.0, allow_nan=False,
            allow_infinity=False)))
        return (tuple(comps), omega, draw(st.integers(0, 3)),
                draw(st.booleans()), timeout_ms)

    class TestHypothesisWireParity:
        @settings(max_examples=60, deadline=None)
        @given(fields=request_fields())
        def test_request_bytes_equal(self, fields):
            comps, omega, page, count_only, timeout_ms = fields
            body = {}
            for pkg in PKGS:
                req = pkg.core.Request(
                    pattern=pkg.core.TriplePattern(*comps), omega=omega,
                    page=page, count_only=count_only, timeout_ms=timeout_ms)
                body[pkg.name] = pkg.wire.dumps(req.to_wire())
            assert body["torch"] == body["jax"]
            out = twire.request_from_wire(twire.loads(body["jax"]))
            assert twire.dumps(out.to_wire()) == body["jax"]


# ---------------------------------------------------------------------------
# ServerConfig on the wire
# ---------------------------------------------------------------------------


class TestServerConfigWire:
    SHARED = dict(page_size=25, max_mpr=10, meta_triples_per_page=5,
                  selector_backend="kernel", shard_window=64,
                  fast_path_rows=64, fuse_patterns=False,
                  placement_policy="heat", heat_capacity=99, queue_depth=7)

    def test_round_trip(self):
        cfg = tcore.ServerConfig(shards=4, **self.SHARED)
        body = json.loads(twire.dumps(cfg.to_wire()))
        assert tcore.ServerConfig.from_wire(body) == cfg

    def test_device_is_host_local_and_shards_travel(self):
        cfg = tcore.ServerConfig(device="cpu", shards=3, **self.SHARED)
        body = json.loads(twire.dumps(cfg.to_wire()))
        assert body["device"] is None and body["shards"] == 3
        back = tcore.ServerConfig.from_wire(body)
        assert back == cfg.replace(device=None)

    def test_reference_body_builds_port_config(self):
        jcfg = jcore.ServerConfig(**self.SHARED)
        body = json.loads(jwire.dumps(jcfg.to_wire()))
        assert "mesh" in body and "shard_axis" in body
        tcfg = tcore.ServerConfig.from_wire(body)
        assert tcfg == tcore.ServerConfig(**self.SHARED)

    def test_port_body_builds_reference_config(self):
        tcfg = tcore.ServerConfig(device="cpu", shards=2, **self.SHARED)
        jcfg = jcore.ServerConfig.from_wire(
            json.loads(twire.dumps(tcfg.to_wire())))
        assert jcfg == jcore.ServerConfig(**self.SHARED)
        shared = set(self.SHARED) | {"heat_capacity"}
        assert {k: getattr(jcfg, k) for k in shared} \
            == {k: getattr(tcfg, k) for k in shared}

    def test_unknown_keys_dropped_and_values_checked(self):
        body = tcore.ServerConfig().to_wire()
        body["from_a_later_version"] = 1
        assert tcore.ServerConfig.from_wire(body) == tcore.ServerConfig()
        with pytest.raises(ValueError):
            tcore.ServerConfig.from_wire(dict(body, shards=0))

    def test_async_front_end_from_config(self):
        cfg = tcore.ServerConfig(page_size=13, max_mpr=7, queue_depth=3)
        front = tcore.AsyncBrTPFServer.from_config(
            tcore.TripleStore(store_array()), cfg)
        assert front.max_mpr == 7
        assert front.server.config == cfg
        assert front.queue_depth == 3


# ---------------------------------------------------------------------------
# ASGI app
# ---------------------------------------------------------------------------


def app_pair(arr, backend="numpy", replicas=1, policy="pattern", **cfg):
    cfg = dict(dict(page_size=20, max_mpr=12), **cfg)
    return {pkg.name: pkg.http.TestClient(pkg.http.app_from_config(
        pkg.core.TripleStore(arr), pkg.config(selector_backend=backend,
                                              **cfg),
        batch_window_s=1e-3, replicas=replicas, policy=policy))
        for pkg in PKGS}


@pytest.fixture()
def apps():
    clients = app_pair(store_array())
    yield clients
    for tc in clients.values():
        tc.close()


def post_all(clients, reqs_by_pkg):
    out = {}
    for name, tc in clients.items():
        out[name] = [tc.post("/fragment", json_body=r.to_wire())
                     for r in reqs_by_pkg[name]]
    return out


class TestHttpApp:
    def test_service_description_equal(self, apps):
        got = {k: tc.get("/") for k, tc in apps.items()}
        assert got["torch"].status_code == 200
        assert got["torch"].content == got["jax"].content
        assert got["torch"].json()["max_mpr"] == 12

    def test_fragments_equal_reference_app_and_in_process(self, apps):
        arr = store_array()
        reqs = {p.name: sample_requests(p, arr, max_mpr=12) for p in PKGS}
        got = post_all(apps, reqs)
        oracle = tcore.BrTPFServer(tcore.TripleStore(arr),
                                   tcore.ServerConfig(page_size=20,
                                                      max_mpr=12))
        for jr, tr, req in zip(got["jax"], got["torch"], reqs["torch"],
                               strict=True):
            assert tr.status_code == jr.status_code == 200
            assert tr.headers["content-type"] == "application/json"
            assert tr.content == jr.content
            assert tr.content == frag_bytes(TORCH, oracle.handle(req))

    def test_get_and_post_encodings_agree(self, apps):
        tc = apps["torch"]
        for req in sample_requests(TORCH, store_array(), count=9,
                                   max_mpr=12):
            params = {"s": req.pattern.s, "p": req.pattern.p,
                      "o": req.pattern.o, "page": req.page}
            if req.omega is not None:
                params["omega"] = json.dumps(req.omega.tolist())
                params["omega_vars"] = req.omega.shape[1]
            get = tc.get("/fragment", params=params)
            post = tc.post("/fragment", json_body=req.to_wire())
            assert get.status_code == post.status_code == 200
            assert get.content == post.content
            assert get.content == apps["jax"].get(
                "/fragment", params=params).content

    @pytest.mark.parametrize("case", ["max_mpr", "bad_version", "bad_int",
                                      "missing_param", "unknown_path",
                                      "post_metrics", "delete_fragment"])
    def test_error_statuses_equal(self, apps, case):
        rng = np.random.default_rng(5)
        got = {}
        for pkg in PKGS:
            tc = apps[pkg.name]
            V, TP = pkg.core.encode_var, pkg.core.TriplePattern
            if case == "max_mpr":
                req = pkg.core.Request(pattern=TP(V(0), 2, V(1)),
                                       omega=rand_omega(rng, 13))
                resp = tc.post("/fragment", json_body=req.to_wire())
            elif case == "bad_version":
                env = pkg.core.Request(pattern=TP(1, 2, 3)).to_wire()
                env["v"] = "tpf/v9"
                resp = tc.post("/fragment", json_body=env)
            elif case == "bad_int":
                resp = tc.get("/fragment",
                              params={"s": "1", "p": "x", "o": "3"})
            elif case == "missing_param":
                resp = tc.get("/fragment", params={"s": "1", "p": "2"})
            elif case == "unknown_path":
                resp = tc.get("/nope")
            elif case == "post_metrics":
                resp = tc.post("/metrics")
            else:
                resp = tc.request("DELETE", "/fragment")
            got[pkg.name] = resp
        want = {"max_mpr": (414, "MAX_MPR_EXCEEDED"),
                "bad_version": (400, "BAD_REQUEST"),
                "bad_int": (400, "BAD_REQUEST"),
                "missing_param": (400, "BAD_REQUEST"),
                "unknown_path": (404, "NOT_FOUND"),
                "post_metrics": (405, "METHOD_NOT_ALLOWED"),
                "delete_fragment": (405, "METHOD_NOT_ALLOWED")}[case]
        t, j = got["torch"], got["jax"]
        assert (t.status_code, t.json()["code"]) == want
        assert t.content == j.content

    def test_metrics_schema_equals_reference_and_in_process(self, apps):
        arr = store_array()
        reqs = {p.name: sample_requests(p, arr, count=6, max_mpr=12)
                for p in PKGS}
        post_all(apps, reqs)
        wire = {k: tc.get("/metrics").json() for k, tc in apps.items()}
        routes = {k: w.pop("routes") for k, w in wire.items()}
        assert wire["torch"] == wire["jax"]
        local = json.loads(twire.dumps(
            apps["torch"].app.backend.metrics_snapshot()))
        assert wire["torch"] == local
        assert wire["torch"]["counters"]["num_requests"] == 6
        assert "batch" in wire["torch"] and "resilience" in wire["torch"]
        expected = set(tmetrics.latency_summary([]))
        assert expected == set(jmetrics.latency_summary([]))
        assert set(routes["torch"]) == set(routes["jax"]) \
            == {"POST /fragment"}
        frag = routes["torch"]["POST /fragment"]
        assert set(frag) == expected and frag["requests"] == 6
        assert 0.0 <= frag["p50_latency_ms"] <= frag["p95_latency_ms"] \
            <= frag["p99_latency_ms"]
        # unknown paths mint no route label
        apps["torch"].get("/definitely-not-a-route")
        assert set(apps["torch"].get("/metrics").json()["routes"]) \
            == {"POST /fragment", "GET /metrics"}

    def test_latency_and_chaos_summaries_equal_reference(self):
        samples = [0.004, 0.001, 0.0025, 0.03, 0.002, 0.0011]
        assert tmetrics.latency_summary(samples, wall_s=0.5) \
            == jmetrics.latency_summary(samples, wall_s=0.5)
        assert tmetrics.chaos_summary(9, 1, 1, samples, parity=0.0) \
            == jmetrics.chaos_summary(9, 1, 1, samples, parity=0.0)
        assert tmetrics.resilience_section(retries=2, breaker={"x": 1}) \
            == jmetrics.resilience_section(retries=2, breaker={"x": 1})

    def test_create_app_wraps_existing_backend(self):
        front = tcore.AsyncBrTPFServer.from_config(
            tcore.TripleStore(store_array()), tcore.ServerConfig(max_mpr=6),
            batch_window_s=1e-3)
        with thttp.TestClient(thttp.create_app(front)) as tc:
            assert tc.get("/").json()["max_mpr"] == 6

    def test_run_app_needs_uvicorn(self, monkeypatch):
        import builtins
        real = builtins.__import__

        def no_uvicorn(name, *args, **kw):
            if name == "uvicorn":
                raise ImportError("no uvicorn")
            return real(name, *args, **kw)

        monkeypatch.setattr(builtins, "__import__", no_uvicorn)
        with pytest.raises(RuntimeError, match="uvicorn"):
            thttp.run_app(None)


@pytest.mark.parametrize("backend,extra", [
    ("numpy", {}),
    ("kernel", {"fast_path_rows": 4}),
    ("sharded-1", {"shard_window": 64}),
    ("sharded-4", {"shard_window": 64}),
])
def test_app_parity_across_backends(backend, extra):
    """The port's app on each backend serves the JAX package's app's
    bytes. The JAX app runs its sharded backend over the process's one
    CPU device: fragments do not depend on the number of shards."""
    arr = store_array(seed=7)
    shards = int(backend.split("-")[1]) if "-" in backend else 1
    backend = backend.split("-")[0]
    clients = app_pair(arr, backend=backend, page_size=25, max_mpr=16,
                       shards=shards, **extra)
    try:
        reqs = {p.name: sample_requests(p, arr, seed=11, count=12,
                                        max_mpr=16) for p in PKGS}
        got = post_all(clients, reqs)
        for jr, tr in zip(got["jax"], got["torch"], strict=True):
            assert tr.status_code == jr.status_code == 200
            assert tr.content == jr.content
        # GET /metrics: the same envelope; only the per-shard section
        # differs, where the port runs 4 shards and the JAX app 1
        wire = {k: tc.get("/metrics").json() for k, tc in clients.items()}
        for w in wire.values():
            del w["routes"]
        if backend == "sharded":
            fed = clients["torch"].app.backend.server.federated
            assert fed.shards == shards
            assert len(wire["torch"].pop("shards")["launches"]) == shards
            assert len(wire["jax"].pop("shards")["launches"]) == 1
        assert wire["torch"] == wire["jax"]
    finally:
        for tc in clients.values():
            tc.close()


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


def run_workload(pkg, transport):
    async def main():
        try:
            client = pkg.core.AsyncBrTPFClient(transport)
            out = {}
            for name, bgp in small_workload(pkg):
                res = await client.execute(bgp)
                out[name] = (canon(res.solutions), res.num_requests)
            return out, await transport.metrics()
        finally:
            await transport.aclose()
    return asyncio.run(main())


@pytest.mark.parametrize("kind", ["loopback", "asgi"])
@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_transports_match_reference(kind, backend):
    arr = store_array(seed=9)
    got = {}
    for pkg in PKGS:
        store = pkg.core.TripleStore(arr)
        cfg = pkg.config(page_size=30, selector_backend=backend)
        if kind == "loopback":
            tr = pkg.transport.LoopbackTransport(
                pkg.core.AsyncBrTPFServer.from_config(store, cfg,
                                                      batch_window_s=1e-3))
        else:
            tr = pkg.transport.AsgiTransport(pkg.http.app_from_config(
                store, cfg, batch_window_s=1e-3))
        got[pkg.name] = run_workload(pkg, tr)
    (tres_, tmet), (jres_, jmet) = got["torch"], got["jax"]
    assert set(tres_) == set(jres_)
    for name in jres_:
        assert np.array_equal(tres_[name][0], jres_[name][0]), name
        assert tres_[name][1] == jres_[name][1], name
    total = sum(n for _, n in jres_.values())
    assert tmet["counters"]["num_requests"] == total
    # the wire boundary charged the attached mappings exactly once
    assert tmet["counters"]["mappings_sent"] \
        == jmet["counters"]["mappings_sent"] > 0
    tmet.pop("routes", None)
    jmet.pop("routes", None)
    assert tmet["counters"] == jmet["counters"]


def test_asgi_transport_maps_statuses():
    """414 -> MaxMprExceeded, 400 -> WireError, 504 -> DeadlineExceeded,
    503 -> retryable TransportError with the batching window as hint."""
    arr = store_array()
    store = tcore.TripleStore(arr)
    V, TP = tcore.encode_var, tcore.TriplePattern

    async def main():
        tr = ttransport.AsgiTransport(thttp.app_from_config(
            store, tcore.ServerConfig(max_mpr=4), batch_window_s=0.05))
        rng = np.random.default_rng(2)
        try:
            with pytest.raises(tcore.MaxMprExceeded):
                await tr.handle(tcore.Request(pattern=TP(V(0), 2, V(1)),
                                              omega=rand_omega(rng, 9)))
            # shed in the batching queue: the app answers 504
            with pytest.raises(tcore.DeadlineExceeded):
                await tr.handle(tcore.Request(pattern=TP(V(0), 2, V(1)),
                                              timeout_ms=1.0))
            resp = await thttp.request_asgi(
                tr.app, "POST", "/fragment", body=b"{not json")
            assert resp.status_code == 400
        finally:
            await tr.aclose()

        sat = ttransport.AsgiTransport(thttp.create_app(
            tcore.AsyncBrTPFServer.from_config(
                store, tcore.ServerConfig(), batch_window_s=0.2,
                queue_depth=1)))
        r1, r2 = sample_requests(TORCH, arr, count=2)
        first = asyncio.ensure_future(sat.handle(r1))
        await asyncio.sleep(0.02)
        try:
            with pytest.raises(ttransport.TransportError) as ei:
                await sat.handle(r2)
            await first
        finally:
            await sat.aclose()
        return ei.value

    exc = asyncio.run(main())
    assert (exc.status, exc.retryable, exc.code) \
        == (503, True, "QUEUE_SATURATED")
    assert exc.retry_after_ms == pytest.approx(200.0)


# ---------------------------------------------------------------------------
# Replica router
# ---------------------------------------------------------------------------


class TestReplicaRouter:
    def test_stable_replica_index_equals_reference(self):
        V = tcore.encode_var
        pats = [(s, 2, V(0)) for s in range(64)] + [
            (V(0), p, o) for p in range(8) for o in range(8)] + [
            (V(0), V(1), V(2)), (2 ** 31 - 1, 0, V(3))]
        for n in (1, 2, 3, 4, 7):
            got = [trouter.stable_replica_index(p, n) for p in pats]
            assert got == [jrouter.stable_replica_index(p, n) for p in pats]
        assert len({trouter.stable_replica_index(p, 4) for p in pats}) > 1

    @pytest.mark.parametrize("policy,want", [
        ("pattern", None), ("round_robin", [0, 1, 2, 0, 1, 2])])
    def test_routing(self, policy, want):
        store = tcore.TripleStore(store_array())
        router = trouter.ReplicaRouter(store, tcore.ServerConfig(),
                                       replicas=3, policy=policy,
                                       batch_window_s=1e-3)
        req = tcore.Request(pattern=tcore.TriplePattern(
            tcore.encode_var(0), 2, tcore.encode_var(1)))
        got = [router.route(req) for _ in range(6)]
        if want is None:
            assert got == [trouter.stable_replica_index(
                req.pattern.as_tuple(), 3)] * 6
        else:
            assert got == want
        asyncio.run(router.aclose())

    def test_invalid_construction(self):
        store = tcore.TripleStore(store_array())
        with pytest.raises(ValueError):
            trouter.ReplicaRouter(store, replicas=0)
        with pytest.raises(ValueError):
            trouter.ReplicaRouter(store, policy="sticky")

    @pytest.mark.parametrize("policy", ["pattern", "round_robin"])
    def test_fleet_parity_and_merged_metrics(self, policy):
        arr = store_array(seed=13)
        got = {}
        for pkg in PKGS:
            reqs = sample_requests(pkg, arr, seed=17, count=18, max_mpr=30)

            async def main(pkg=pkg, reqs=reqs):
                router = pkg.router.ReplicaRouter(
                    pkg.core.TripleStore(arr), pkg.config(page_size=30),
                    replicas=3, policy=policy, batch_window_s=1e-3)
                try:
                    frags = [await router.handle(r) for r in reqs]
                    return ([frag_bytes(pkg, f) for f in frags],
                            router.metrics_snapshot())
                finally:
                    await router.aclose()
            got[pkg.name] = asyncio.run(main())
        (tb, tsnap), (jb, jsnap) = got["torch"], got["jax"]
        assert tb == jb
        assert tsnap["counters"]["num_requests"] == 18
        assert tsnap["router"] == jsnap["router"]
        assert sum(tsnap["router"]["requests_per_replica"]) == 18
        assert len(tsnap["replicas"]) == 3
        # the merged snapshot: same schema and numbers as the reference
        assert json.loads(twire.dumps(tsnap)) == json.loads(
            jwire.dumps(jsnap))

    def test_router_behind_asgi_app(self):
        arr = store_array()
        clients = app_pair(arr, page_size=25, max_mpr=30, replicas=2)
        try:
            reqs = {p.name: sample_requests(p, arr, seed=19, count=8)
                    for p in PKGS}
            got = post_all(clients, reqs)
            for jr, tr in zip(got["jax"], got["torch"], strict=True):
                assert tr.status_code == 200
                assert tr.content == jr.content
            snap = clients["torch"].get("/metrics").json()
            assert snap["router"]["replicas"] == 2
        finally:
            for tc in clients.values():
                tc.close()


# ---------------------------------------------------------------------------
# Faults, breakers, retries, deadlines
# ---------------------------------------------------------------------------


def decisions(faults, n=40):
    async def main():
        out = []
        for _ in range(n):
            try:
                await faults.perturb()
                out.append("ok")
            except Exception as exc:   # the InjectedFault of either package
                out.append(f"err{exc.status}:{exc.code}:{exc.retryable}")
        return out
    return asyncio.run(main())


SPECS = [
    dict(error_rate=0.5),
    dict(error_rate=0.05, stall_after=2, stall_s=0.0),
    dict(error_rate=0.3, error_status=500, drop_rate=0.2),
    dict(crash_after=3),
    dict(error_rate=0.2, error_status=502, delay_s=1e-4),
]


class TestFaultPlan:
    @pytest.mark.parametrize("spec", range(len(SPECS)))
    @pytest.mark.parametrize("replica", [0, 1, 3])
    def test_schedule_equals_reference(self, spec, replica, monkeypatch):
        monkeypatch.setattr(jfaults.ReplicaFaults, "DROP_STALL_S", 0.0)
        monkeypatch.setattr(tfaults.ReplicaFaults, "DROP_STALL_S", 0.0)
        got = {}
        for pkg in PKGS:
            plan = pkg.faults.FaultPlan(
                seed=1608, default=pkg.faults.FaultSpec(error_rate=0.05),
                per_replica={replica: pkg.faults.FaultSpec(**SPECS[spec])})
            faults = plan.for_replica(replica)
            got[pkg.name] = (decisions(faults), faults.summary(),
                             faults.rng.random())
        assert got["torch"] == got["jax"]

    def test_replicas_draw_distinct_streams(self):
        plan = tfaults.FaultPlan(seed=7,
                                 default=tfaults.FaultSpec(error_rate=0.5))
        a = decisions(plan.for_replica(0))
        assert a == decisions(plan.for_replica(0))
        assert a != decisions(plan.for_replica(1))
        assert any(x.startswith("err503") for x in a) and "ok" in a

    def test_crash_after_is_a_cliff(self):
        plan = tfaults.FaultPlan(per_replica={0: tfaults.FaultSpec(
            crash_after=3)})
        got = decisions(plan.for_replica(0), n=6)
        assert got == ["ok"] * 3 + ["err500:INTERNAL:False"] * 3

    @pytest.mark.parametrize("kw", [dict(error_rate=1.5),
                                    dict(drop_rate=-0.1),
                                    dict(delay_s=-1), dict(stall_s=-1),
                                    dict(stall_after=-1),
                                    dict(crash_after=-2)])
    def test_spec_validation(self, kw):
        with pytest.raises(ValueError):
            tfaults.FaultSpec(**kw)
        assert tfaults.FaultSpec().is_noop

    @pytest.mark.parametrize("wrapper", ["backend", "transport", "app"])
    def test_aclose_releases_a_stalled_request(self, wrapper):
        """A replica stalled for 30 s is closed at once: its held
        requests are cancelled, not waited out."""
        store = tcore.TripleStore(store_array())
        front = tcore.AsyncBrTPFServer.from_config(
            store, tcore.ServerConfig(), batch_window_s=1e-3)
        faults = tfaults.FaultPlan(default=tfaults.FaultSpec(
            stall_after=0, stall_s=30.0)).for_replica(0)
        if wrapper == "backend":
            tr = ttransport.LoopbackTransport(
                tfaults.FaultyBackend(front, faults))
        elif wrapper == "transport":
            tr = tfaults.FaultyTransport(
                ttransport.LoopbackTransport(front), faults)
        else:
            tr = ttransport.AsgiTransport(tfaults.FaultyApp(
                thttp.create_app(front), faults))
        req = tcore.Request(pattern=tcore.TriplePattern(
            tcore.encode_var(0), 2, tcore.encode_var(1)))

        async def main():
            held = asyncio.ensure_future(tr.handle(req))
            await asyncio.sleep(0.05)
            assert not held.done()
            t0 = time.perf_counter()
            await tr.aclose()
            with pytest.raises(asyncio.CancelledError):
                await held
            return time.perf_counter() - t0

        assert asyncio.run(main()) < 1.0
        assert faults.stats.stalls == 1


class TestCircuitBreaker:
    EVENTS = ["f", "f", "allow", "f", "allow", "t6", "allow", "allow", "s",
              "allow", "f", "f", "f", "t13", "allow", "f", "t20", "allow",
              "s", "f"]

    def test_state_machine_equals_reference(self):
        got = {}
        for pkg in PKGS:
            clock = {"t": 0.0}
            cb = pkg.router.CircuitBreaker(failure_threshold=3,
                                           reset_after_s=5.0,
                                           clock=lambda c=clock: c["t"])
            trail = []
            for ev in self.EVENTS:
                if ev == "f":
                    cb.record_failure()
                elif ev == "s":
                    cb.record_success()
                elif ev == "allow":
                    trail.append(cb.allow())
                else:
                    clock["t"] = float(ev[1:])
                trail.append(cb.snapshot())
            got[pkg.name] = trail
        assert got["torch"] == got["jax"]
        assert any(s["opens"] == 2 for s in got["torch"]
                   if isinstance(s, dict))

    def test_invalid_construction(self):
        with pytest.raises(ValueError):
            trouter.CircuitBreaker(failure_threshold=0)
        with pytest.raises(ValueError):
            trouter.CircuitBreaker(reset_after_s=0)


class _Flaky:
    """Fails the first ``failures`` calls, then delegates to ``inner``
    (or returns ``payload``)."""

    max_mpr = 30

    def __init__(self, failures, exc=None, inner=None, payload="frag"):
        self.remaining = failures
        self.exc = exc or ttransport.TransportError(503, "busy",
                                                    retryable=True)
        self.inner = inner
        self.payload = payload
        self.calls = 0

    async def handle(self, req):
        self.calls += 1
        if self.remaining > 0:
            self.remaining -= 1
            raise self.exc
        if self.inner is not None:
            return await self.inner.handle(req)
        return self.payload

    async def metrics(self):
        return {} if self.inner is None else await self.inner.metrics()

    async def aclose(self):
        if self.inner is not None:
            await self.inner.aclose()


FAST = dict(base_backoff_s=1e-4, max_backoff_s=1e-3)
REQ = tcore.Request(pattern=tcore.TriplePattern(1, 2, 3))


class TestResilientTransport:
    @pytest.mark.parametrize("exc,want", [
        (tcore.QueueSaturated("full"), True),
        (tcore.DeadlineExceeded("late"), True),
        (asyncio.TimeoutError(), True),
        (ttransport.TransportError(503, "busy", retryable=True), True),
        (ttransport.TransportError(408, "x"), True),
        (ttransport.TransportError(500, "x"), True),
        (ttransport.TransportError(502, "x"), True),
        (ttransport.TransportError(504, "x"), True),
        (ttransport.TransportError(400, "bad envelope"), False),
        (ttransport.TransportError(414, "over maxMpR"), False),
        (ttransport.TransportError(404, "nope"), False),
        (twire.WireError("garbled"), False),
        (ValueError("client bug"), False),
    ])
    def test_is_retryable(self, exc, want):
        assert tres.is_retryable(exc) is want
        assert tres.RETRYABLE_STATUSES == jres.RETRYABLE_STATUSES

    def test_jitter_draws_equal_reference(self):
        import random
        kw = dict(base_backoff_s=2e-3, max_backoff_s=0.05)
        tp, jp = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
        trng, jrng = random.Random(1608), random.Random(1608)
        assert [tp.backoff_s(a, trng) for a in range(1, 12)] \
            == [jp.backoff_s(a, jrng) for a in range(1, 12)]

    def test_retry_to_success_preserves_bytes(self):
        arr = store_array()
        store = tcore.TripleStore(arr)
        cfg = tcore.ServerConfig(page_size=25)
        oracle = tcore.BrTPFServer(store, cfg)
        reqs = sample_requests(TORCH, arr, count=6)
        expected = [frag_bytes(TORCH, oracle.handle(r)) for r in reqs]

        async def main():
            inner = _Flaky(4, inner=ttransport.LoopbackTransport(
                tcore.AsyncBrTPFServer.from_config(store, cfg,
                                                   batch_window_s=1e-3)))
            tr = tres.ResilientTransport(inner, tres.RetryPolicy(
                max_attempts=6, **FAST))
            try:
                return [await tr.handle(r) for r in reqs], tr.stats
            finally:
                await tr.aclose()

        frags, stats = asyncio.run(main())
        assert [frag_bytes(TORCH, f) for f in frags] == expected
        assert (stats.retries, stats.giveups) == (4, 0)

    def test_non_retryable_raises_immediately(self):
        flaky = _Flaky(10, exc=ttransport.TransportError(400, "bad"))
        tr = tres.ResilientTransport(flaky, tres.RetryPolicy(
            max_attempts=5, **FAST))
        with pytest.raises(ttransport.TransportError):
            asyncio.run(tr.handle(REQ))
        assert (flaky.calls, tr.stats.retries) == (1, 0)

    def test_gives_up_after_max_attempts(self):
        flaky = _Flaky(10)
        tr = tres.ResilientTransport(flaky, tres.RetryPolicy(
            max_attempts=3, **FAST))
        with pytest.raises(ttransport.TransportError):
            asyncio.run(tr.handle(REQ))
        assert (flaky.calls, tr.stats.retries, tr.stats.giveups) \
            == (3, 2, 1)

    def test_deadline_budget_bounds_the_retry_loop(self):
        flaky = _Flaky(10 ** 6)
        tr = tres.ResilientTransport(flaky, tres.RetryPolicy(
            max_attempts=10 ** 6, base_backoff_s=0.01, max_backoff_s=0.02,
            deadline_ms=60.0))
        with pytest.raises(tcore.DeadlineExceeded):
            asyncio.run(tr.handle(REQ))
        assert tr.stats.deadline_exceeded == 1
        assert 1 <= flaky.calls < 100

    def test_retry_after_hint_floors_the_backoff(self):
        flaky = _Flaky(1, exc=ttransport.TransportError(
            503, "busy", retryable=True, retry_after_ms=40.0))
        tr = tres.ResilientTransport(flaky, tres.RetryPolicy(
            max_attempts=3, **FAST))

        async def main():
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            await tr.handle(REQ)
            return loop.time() - t0

        assert asyncio.run(main()) >= 0.04

    def test_hedge_cuts_a_slow_primary(self):
        class SlowFirst:
            max_mpr = 30

            def __init__(self):
                self.calls = 0

            async def handle(self, req):
                self.calls += 1
                if self.calls == 1:
                    await asyncio.sleep(0.5)
                    return "slow"
                return "fast"

            async def metrics(self):
                return {}

            async def aclose(self):
                pass

        tr = tres.ResilientTransport(SlowFirst(), tres.RetryPolicy(
            hedge=True, hedge_after_s=0.01, **FAST))
        assert asyncio.run(tr.handle(REQ)) == "fast"
        assert (tr.stats.hedges, tr.stats.hedge_wins) == (1, 1)

    def test_metrics_overlay_resilience_section(self):
        tr = tres.ResilientTransport(_Flaky(2), tres.RetryPolicy(
            max_attempts=5, **FAST))

        async def main():
            await tr.handle(REQ)
            return await tr.metrics()

        section = asyncio.run(main())["resilience"]
        assert set(section) == set(jmetrics.resilience_section())
        assert (section["retries"], section["hedges"]) == (2, 0)

    @pytest.mark.parametrize("kw", [dict(max_attempts=0),
                                    dict(deadline_ms=0),
                                    dict(attempt_timeout_ms=-1),
                                    dict(base_backoff_s=-1),
                                    dict(hedge_min_samples=0)])
    def test_policy_validation(self, kw):
        with pytest.raises(ValueError):
            tres.RetryPolicy(**kw)


class TestDeadlinesAndShedding:
    @pytest.mark.parametrize("kind", ["loopback", "asgi"])
    def test_tight_deadline_expires_on_both_transports(self, kind):
        store = tcore.TripleStore(store_array())
        front = tcore.AsyncBrTPFServer.from_config(
            store, tcore.ServerConfig(page_size=25), batch_window_s=1e-3)
        faults = tfaults.FaultPlan(default=tfaults.FaultSpec(
            delay_s=0.3)).for_replica(0)
        slow = tfaults.FaultyBackend(front, faults)
        tr = (ttransport.LoopbackTransport(slow) if kind == "loopback"
              else ttransport.AsgiTransport(tfaults.FaultyApp(
                  thttp.create_app(front), faults)))
        req = tcore.Request(pattern=tcore.TriplePattern(
            tcore.encode_var(0), 2, tcore.encode_var(1)), timeout_ms=25.0)

        async def main():
            try:
                with pytest.raises(tcore.DeadlineExceeded):
                    await tr.handle(req)
            finally:
                await tr.aclose()

        asyncio.run(main())

    def test_generous_deadline_succeeds(self):
        front = tcore.AsyncBrTPFServer.from_config(
            tcore.TripleStore(store_array()), tcore.ServerConfig(),
            batch_window_s=1e-3)
        tr = ttransport.LoopbackTransport(front)
        req = tcore.Request(pattern=tcore.TriplePattern(
            tcore.encode_var(0), 2, tcore.encode_var(1)),
            timeout_ms=30_000.0)

        async def main():
            try:
                return await tr.handle(req)
            finally:
                await tr.aclose()

        assert asyncio.run(main()).cnt >= 0

    @pytest.mark.parametrize("timeout_ms,window", [(1.0, 0.05),
                                                   (0.0, 1e-3)])
    def test_expired_work_is_shed(self, timeout_ms, window):
        """Shed at flush (budget expires in the window) and at enqueue
        (already expired): the same batch accounting as the reference."""
        got = {}
        for pkg in PKGS:
            front = pkg.core.AsyncBrTPFServer.from_config(
                pkg.core.TripleStore(store_array()), pkg.config(),
                batch_window_s=window)
            req = pkg.core.Request(pattern=pkg.core.TriplePattern(
                pkg.core.encode_var(0), 2, pkg.core.encode_var(1)),
                timeout_ms=timeout_ms)

            async def main(pkg=pkg, front=front, req=req):
                tr = pkg.transport.LoopbackTransport(front)
                try:
                    with pytest.raises(pkg.core.DeadlineExceeded):
                        await front.handle(req)
                    return await tr.metrics()
                finally:
                    await tr.aclose()

            snap = asyncio.run(main())
            got[pkg.name] = (dataclasses.asdict(front.stats), snap["batch"],
                             snap["resilience"])
        assert got["torch"] == got["jax"]
        stats, batch, section = got["torch"]
        assert stats["shed"] == batch["shed"] == section["shed"] == 1
        if timeout_ms == 0.0:
            assert stats["flushes"] == 0


class TestRouterFailover:
    def test_breaker_detours_around_a_dead_replica(self):
        arr = store_array(seed=13)
        store = tcore.TripleStore(arr)
        cfg = tcore.ServerConfig(page_size=30)
        oracle = tcore.BrTPFServer(store, cfg)
        reqs = sample_requests(TORCH, arr, seed=17, count=12)
        expected = [frag_bytes(TORCH, oracle.handle(r)) for r in reqs]
        plan = tfaults.FaultPlan(seed=3, per_replica={
            0: tfaults.FaultSpec(crash_after=0)})

        async def main():
            router = trouter.ReplicaRouter(
                store, cfg, replicas=3, batch_window_s=1e-3,
                failure_threshold=2, reset_after_s=60.0, fault_plan=plan)
            assert any(router.route(r) == 0 for r in reqs)
            tr = tres.ResilientTransport(
                ttransport.LoopbackTransport(router),
                tres.RetryPolicy(max_attempts=6, **FAST))
            try:
                frags = [await tr.handle(r) for r in reqs]
                return frags, router.metrics_snapshot()
            finally:
                await tr.aclose()

        frags, snap = asyncio.run(main())
        assert [frag_bytes(TORCH, f) for f in frags] == expected
        breaker = snap["resilience"]["breaker"]
        assert breaker["opens"] >= 1
        assert breaker["states"][0] == trouter.BREAKER_OPEN
        assert breaker["failovers"] > 0
        assert breaker["replica_failures"] >= 2
        assert snap["faults"][0]["crashes"] >= 2

    def test_half_open_probe_readmits_a_recovered_replica(self):
        arr = store_array()
        store = tcore.TripleStore(arr)

        async def main():
            router = trouter.ReplicaRouter(store, tcore.ServerConfig(),
                                           replicas=2, batch_window_s=1e-3,
                                           failure_threshold=1,
                                           reset_after_s=0.02)
            try:
                req = next(r for r in sample_requests(TORCH, arr, seed=23,
                                                      count=32)
                           if router.route(r) == 0)
                router.breakers[0].record_failure()
                assert not router.breakers[0].allow()
                await asyncio.sleep(0.05)
                await router.handle(req)
                return router.metrics_snapshot()
            finally:
                await router.aclose()

        snap = asyncio.run(main())
        states = snap["resilience"]["breaker"]["states"]
        assert states == [trouter.BREAKER_CLOSED] * 2
        assert "faults" not in snap

    def test_resilient_client_rides_out_injected_errors(self):
        arr = store_array(seed=5)
        store = tcore.TripleStore(arr)
        cfg = tcore.ServerConfig(page_size=30)
        V = tcore.encode_var
        bgp = tcore.bgp_from_arrays([(V(0), 2, V(1)), (V(1), 3, V(2))])
        want = tcore.BrTPFClient(tcore.BrTPFServer(store, cfg)).execute(
            bgp).solutions
        front = tcore.AsyncBrTPFServer.from_config(store, cfg,
                                                   batch_window_s=1e-3)
        faults = tfaults.FaultPlan(seed=7, default=tfaults.FaultSpec(
            error_rate=0.5)).for_replica(0)
        tr = tres.ResilientTransport(
            ttransport.AsgiTransport(tfaults.FaultyApp(
                thttp.create_app(front), faults)),
            tres.RetryPolicy(max_attempts=12, **FAST), seed=7)

        async def main():
            try:
                return (await tcore.AsyncBrTPFClient(tr).execute(bgp)) \
                    .solutions
            finally:
                await tr.aclose()

        got = asyncio.run(main())
        assert np.array_equal(canon(got), canon(want))
        assert tr.stats.retries > 0
        # /metrics is never perturbed
        assert faults.stats.calls == tr.stats.attempts


# ---------------------------------------------------------------------------
# A small chaos run of both packages
# ---------------------------------------------------------------------------


class _Outcome:
    """Counts and times client-visible request outcomes."""

    def __init__(self, inner):
        self.inner = inner
        self.ok = self.failed = 0
        self.samples_s = []

    @property
    def max_mpr(self):
        return self.inner.max_mpr

    async def handle(self, req):
        t0 = time.perf_counter()
        try:
            frag = await self.inner.handle(req)
        except Exception:
            self.failed += 1
            raise
        self.ok += 1
        self.samples_s.append(time.perf_counter() - t0)
        return frag

    async def metrics(self):
        return await self.inner.metrics()

    async def aclose(self):
        await self.inner.aclose()


def chaos_workload(pkg, arr):
    """Two-pattern chains over the store's most frequent predicates."""
    V = pkg.core.encode_var
    preds = [int(p) for p in np.unique(arr[:, 1])[:6]]
    return [(f"c{i}", pkg.core.bgp_from_arrays(
        [[V(0), a, V(1)], [V(1), b, V(2)]]))
        for i, (a, b) in enumerate(zip(preds, preds[1:] + preds[:1],
                                       strict=True))]


def run_chaos(pkg, arr, backend, resilient, clients=16):
    """The JAX package's chaos plan (benchmarks/chaos.py) at test scale:
    4 replicas, seed 1608, 5% injected 503s on every replica, replica 1
    stalled for 30 s after 2 requests; 16 clients over the ASGI edge.
    Deadlines are shortened (attempt 100 ms, A/B 300 ms) to keep the
    test short."""
    store = pkg.core.TripleStore(arr)
    cfg = pkg.config(page_size=20, selector_backend=backend)
    wl = list(enumerate(chaos_workload(pkg, arr)))
    oracle = {i: canon(pkg.core.BrTPFClient(pkg.core.BrTPFServer(
        store, cfg)).execute(b).solutions) for i, (_, b) in wl}
    plan = pkg.faults.FaultPlan(
        seed=1608, default=pkg.faults.FaultSpec(error_rate=0.05),
        per_replica={1: pkg.faults.FaultSpec(error_rate=0.05, stall_after=2,
                                             stall_s=30.0)})
    router = pkg.router.ReplicaRouter(store, cfg, replicas=4,
                                      fault_plan=plan, failure_threshold=2,
                                      reset_after_s=0.5,
                                      batch_window_s=1e-3)
    base = pkg.transport.AsgiTransport(pkg.http.create_app(router))
    inner = pkg.res.ResilientTransport(base, pkg.res.RetryPolicy(
        max_attempts=10, base_backoff_s=2e-3, max_backoff_s=0.05,
        deadline_ms=8000.0, attempt_timeout_ms=100.0, hedge=True),
        seed=1608) if resilient else base
    probe = _Outcome(inner)
    per_client = pkg.sim.split_workload(wl * 2, clients)
    state = {"failed_queries": 0, "mismatches": 0}

    async def one(client, queries):
        for i, (_, bgp) in queries:
            try:
                res = await client.execute(bgp)
            except Exception:
                state["failed_queries"] += 1
                continue
            if not np.array_equal(canon(res.solutions), oracle[i]):
                state["mismatches"] += 1

    async def main():
        cs = [pkg.core.AsyncBrTPFClient(
            probe, deadline_ms=None if resilient else 300.0)
            for _ in range(clients)]
        try:
            await asyncio.gather(*[one(c, w) for c, w in
                                   zip(cs, per_client, strict=True)])
            return await probe.metrics()
        finally:
            await probe.aclose()

    t0 = time.perf_counter()
    snap = asyncio.run(main())
    wall = time.perf_counter() - t0
    out = pkg.metrics.chaos_summary(
        probe.ok, probe.failed, state["failed_queries"], probe.samples_s,
        wall_s=wall, parity=float(state["mismatches"] == 0))
    out["breaker"] = snap["resilience"]["breaker"]
    out["wall_s"] = wall
    return out


@pytest.mark.parametrize("pkg,backend", [
    (JAX, "numpy"), (TORCH, "numpy"), (TORCH, "kernel")],
    ids=["jax-numpy", "torch-numpy", "torch-kernel"])
def test_small_chaos_run(pkg, backend):
    arr = store_array(seed=21, n=900, terms=24)
    r = run_chaos(pkg, arr, backend, resilient=True)
    assert r["success_rate"] >= 0.999, r
    assert r["failed_queries"] == 0 and r["parity"] == 1.0, r
    assert r["breaker"]["opens"] >= 1, r
    ab = run_chaos(pkg, arr, backend, resilient=False)
    assert ab["failed_queries"] >= 1, ab
    # the stalled replica's held requests never hold up the run
    assert r["wall_s"] < 20 and ab["wall_s"] < 20
