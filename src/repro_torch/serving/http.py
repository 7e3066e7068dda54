"""ASGI transport for the combined TPF/brTPF server (brtpf/v1 wire API).

The port's copy of ``repro.serving.http``. The paper's whole argument is
about *network* load; this module gives the async front end a real HTTP
boundary:

* ``GET  /``          -- service description (version, endpoints, maxMpR);
* ``GET  /fragment``  -- TPF and brTPF page requests via query params
  (``s``/``p``/``o`` pattern ints, ``page``, optional ``omega`` as a
  JSON list of int lists -- the GET-parameter encoding of the paper's
  request URL);
* ``POST /fragment``  -- the same request as a brtpf/v1 ``request``
  envelope body (``core/wire.py``);
* ``GET  /metrics``   -- the canonical metrics snapshot
  (``core/metrics.py``), same keys over the wire as in-process, plus a
  transport-only ``routes`` section: server-side per-endpoint latency
  quantiles over a bounded window of recent requests, in the SAME
  ``latency_summary()`` schema the closed-loop load generator reports
  client-side -- so an SLO gate can read either side of the wire.

An over-maxMpR request maps to **HTTP 414** (the paper's URL-length
rationale for maxMpR made literal); malformed envelopes map to 400.
Responses are brtpf/v1 ``fragment`` envelopes, byte-identical in
content to an in-process ``handle`` call on every selector backend
(tests/test_torch_serving.py asserts this, against the JAX package's
app too).

The app is a plain ASGI-3 callable -- no framework required. When
``uvicorn`` is installed the same app runs under a real server via
:func:`run_app`; :class:`TestClient` drives it fully in-process for
tests and the closed-loop load generator, mirroring the
``starlette.testclient`` surface (sage-engine's test shape) without
the dependency.
"""
from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from ..core import trace as _trace
from ..core.batching import (DEFAULT_BATCH_WINDOW_S, DEFAULT_MAX_BATCH,
                             AsyncBrTPFServer, DeadlineExceeded,
                             QueueSaturated)
from ..core.metrics import latency_summary
from ..core.server import MaxMprExceeded
from ..core.wire import (WIRE_VERSION, KIND_REQUEST, WireError, dumps,
                         envelope, error_to_wire, fragment_to_wire, loads,
                         request_from_wire)

_JSON_HEADERS = [(b"content-type", b"application/json")]

# Per-route latency window: how many recent request durations each
# endpoint retains. Bounded so a long-lived server cannot grow metrics
# state without bound; 2048 samples keep p99 meaningful (nearest-rank
# needs ~100+ samples) while costing a few KiB per route.
ROUTE_SAMPLE_CAP = 2048

# Endpoints whose latency is recorded (unknown paths are not: an
# attacker probing random URLs must not mint unbounded route labels).
_ROUTED_PATHS = ("/", "/fragment", "/metrics")


class RouteLatency:
    """Server-side per-endpoint latency recorder.

    Keeps the last :data:`ROUTE_SAMPLE_CAP` request durations per
    ``"METHOD /path"`` label and summarizes them through the shared
    :func:`~repro_torch.core.metrics.latency_summary` schema -- p50/p95/p99/
    mean milliseconds plus ``req_per_s`` -- so ``GET /metrics`` exposes
    the same quantile keys server-side that a closed-loop load generator
    measures client-side. ``req_per_s`` is computed over the wall time
    since the route's first recorded request (the SLO-relevant arrival
    rate, not the sum of service times). The app times a request once:
    the same two clock readings bound its ``request`` span
    (core/trace.py) while a profiler is on.
    """

    def __init__(self, cap: int = ROUTE_SAMPLE_CAP) -> None:
        self._cap = int(cap)
        self._samples: Dict[str, Deque[float]] = {}
        self._started: Dict[str, float] = {}

    def record(self, route: str, seconds: float, now: float) -> None:
        window = self._samples.get(route)
        if window is None:
            window = self._samples[route] = deque(maxlen=self._cap)
            self._started[route] = now - seconds
        window.append(seconds)

    def summary(self, now: Optional[float] = None) -> dict:
        now = time.perf_counter() if now is None else now
        return {route: latency_summary(
                    list(window),
                    wall_s=max(now - self._started[route], 1e-9))
                for route, window in sorted(self._samples.items())}


class BrTPFApp:
    """ASGI-3 application over an async brTPF backend.

    ``backend`` is anything with ``async handle(Request) -> Fragment``,
    ``metrics_snapshot()``, ``note_mappings(Request)``, ``max_mpr`` and
    ``async aclose()`` -- an :class:`~repro_torch.core.batching.AsyncBrTPFServer`
    (one origin) or a :class:`~repro_torch.serving.router.ReplicaRouter`
    (a replica fleet). Everything the handlers await is async; the
    origin's kernel work runs inside the backend's batching flush.
    """

    def __init__(self, backend) -> None:
        self.backend = backend
        self.route_latency = RouteLatency()

    @property
    def max_mpr(self) -> int:
        return self.backend.max_mpr

    async def aclose(self) -> None:
        await self.backend.aclose()

    # -- ASGI entry ----------------------------------------------------------

    async def __call__(self, scope, receive, send) -> None:
        if scope["type"] == "lifespan":
            await self._lifespan(receive, send)
            return
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported ASGI scope {scope['type']!r}")
        method = scope["method"]
        path = scope["path"]
        span = None
        if path == "/fragment" and _trace.enabled():
            span, token = _trace.request_span()
            t0 = span.t0
        else:
            t0 = time.perf_counter_ns()
        try:
            if path == "/fragment" and method in ("GET", "POST"):
                await self._fragment(scope, receive, send, method)
            elif path == "/metrics" and method == "GET":
                await self._send_json(send, 200, self._metrics())
            elif path == "/" and method == "GET":
                await self._send_json(send, 200, self._describe())
            elif path in _ROUTED_PATHS:
                await self._send_json(
                    send, 405, error_to_wire(405, f"method {method} not "
                                                  f"allowed on {path}",
                                             code="METHOD_NOT_ALLOWED"))
            else:
                await self._send_json(
                    send, 404, error_to_wire(404, f"unknown path {path!r}",
                                             code="NOT_FOUND"))
        finally:
            t1 = time.perf_counter_ns()
            if span is not None:
                _trace.end_request(span, token, t1)
            if path in _ROUTED_PATHS:
                self.route_latency.record(f"{method} {path}",
                                          (t1 - t0) / 1e9, t1 / 1e9)

    async def _lifespan(self, receive, send) -> None:
        while True:
            message = await receive()
            if message["type"] == "lifespan.startup":
                await send({"type": "lifespan.startup.complete"})
            elif message["type"] == "lifespan.shutdown":
                await self.backend.aclose()
                await send({"type": "lifespan.shutdown.complete"})
                return

    # -- handlers ------------------------------------------------------------

    def _metrics(self) -> dict:
        """Backend snapshot plus the transport-only per-route latency
        section. ``routes`` is added HERE and not in metrics_snapshot:
        only the wire layer has routes, and the in-process snapshot
        must stay byte-comparable across surfaces that have none."""
        snap = self.backend.metrics_snapshot()
        snap["routes"] = self.route_latency.summary()
        return snap

    def _describe(self) -> dict:
        return envelope(
            "description",
            endpoints={"fragment": ["GET", "POST"], "metrics": ["GET"]},
            max_mpr=self.backend.max_mpr,
        )

    async def _fragment(self, scope, receive, send, method: str) -> None:
        try:
            if method == "POST":
                body = await self._read_body(receive)
                req = request_from_wire(loads(body))
            else:
                req = request_from_wire(
                    _query_to_request_envelope(scope["query_string"]))
        except WireError as exc:
            await self._send_json(send, 400, error_to_wire(
                400, str(exc), code="BAD_REQUEST"))
            return
        # The wire boundary charges the attached mappings (in-process
        # clients charge Counters.mappings_sent themselves).
        self.backend.note_mappings(req)
        try:
            frag = await self.backend.handle(req)
        except MaxMprExceeded as exc:
            # the paper's maxMpR bound exists because Omega rides the
            # request URL: too many mappings = URI too long
            await self._send_json(send, 414, error_to_wire(
                414, str(exc), code="MAX_MPR_EXCEEDED"))
            return
        except QueueSaturated as exc:
            # admission control (docs/serving.md): the batching queue is
            # full; retryable -- it drains within one batching window,
            # which is exactly the retry_after_ms floor advertised here
            window_s = getattr(self.backend, "batch_window_s", None)
            await self._send_json(
                send, 503, error_to_wire(
                    503, str(exc), retryable=True, code="QUEUE_SATURATED",
                    retry_after_ms=(None if window_s is None
                                    else max(window_s, 0.0) * 1e3)))
            return
        except DeadlineExceeded as exc:
            # deadline-aware shedding (docs/resilience.md): the request's
            # budget expired in the batching queue; retryable -- the next
            # attempt may hit a resident page or a healthier replica
            await self._send_json(
                send, 504, error_to_wire(504, str(exc), retryable=True,
                                         code="DEADLINE_EXCEEDED"))
            return
        await self._send_json(send, 200, fragment_to_wire(frag))

    # -- ASGI plumbing -------------------------------------------------------

    @staticmethod
    async def _read_body(receive) -> bytes:
        chunks: List[bytes] = []
        while True:
            message = await receive()
            if message["type"] != "http.request":
                raise WireError("connection closed before body complete")
            chunks.append(message.get("body", b""))
            if not message.get("more_body", False):
                return b"".join(chunks)

    @staticmethod
    async def _send_json(send, status: int, obj: dict) -> None:
        body = dumps(obj)
        await send({
            "type": "http.response.start",
            "status": status,
            "headers": _JSON_HEADERS
            + [(b"content-length", str(len(body)).encode("ascii"))],
        })
        await send({"type": "http.response.body", "body": body})


def _query_to_request_envelope(query_string: bytes) -> dict:
    """GET-parameter encoding -> brtpf/v1 request envelope.

    The decode then flows through the SAME ``request_from_wire`` as the
    POST body path, so validation and semantics cannot diverge between
    the two encodings.
    """
    params = parse_qs(query_string.decode("utf-8"), keep_blank_values=True)

    def one(name: str, default: Optional[str] = None) -> Optional[str]:
        vals = params.get(name)
        if not vals:
            if default is None and name in ("s", "p", "o"):
                raise WireError(f"missing query param {name!r}")
            return default
        if len(vals) > 1:
            raise WireError(f"duplicate query param {name!r}")
        return vals[0]

    def as_int(name: str, raw: str) -> int:
        try:
            return int(raw)
        except ValueError:
            raise WireError(f"query param {name!r} must be an int, "
                            f"got {raw!r}") from None

    pattern = [as_int(n, one(n)) for n in ("s", "p", "o")]
    page = as_int("page", one("page", "0"))
    omega = None
    omega_vars = None
    raw_omega = one("omega", "")
    if raw_omega:
        try:
            omega = json.loads(raw_omega)
        except ValueError as exc:
            raise WireError(f"query param 'omega' must be JSON: "
                            f"{exc}") from None
        if omega is not None and not isinstance(omega, list):
            raise WireError("query param 'omega' must be a JSON list")
    raw_vars = one("omega_vars", "")
    if raw_vars:
        omega_vars = as_int("omega_vars", raw_vars)
    elif isinstance(omega, list) and omega:
        omega_vars = len(omega[0]) if isinstance(omega[0], list) else None
    return {"v": WIRE_VERSION, "kind": KIND_REQUEST, "pattern": pattern,
            "omega": omega, "omega_vars": omega_vars, "page": page}


# ---------------------------------------------------------------------------
# App factories
# ---------------------------------------------------------------------------


def create_app(backend) -> BrTPFApp:
    """Wrap an existing async backend (front end or router) as ASGI."""
    return BrTPFApp(backend)


def app_from_config(store, config=None, *,
                    batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
                    max_batch: int = DEFAULT_MAX_BATCH,
                    cache=None, replicas: int = 1,
                    policy: str = "pattern") -> BrTPFApp:
    """Build the full serving edge from one
    :class:`~repro_torch.core.config.ServerConfig` -- the same value object
    ``BrTPFServer`` and ``AsyncBrTPFServer`` take, so the in-process
    servers the tests compare against are provably configured
    identically. ``replicas > 1`` puts a
    :class:`~repro_torch.serving.router.ReplicaRouter` behind the app.
    """
    if replicas > 1:
        from .router import ReplicaRouter
        return BrTPFApp(ReplicaRouter(
            store, config, replicas=replicas, policy=policy,
            batch_window_s=batch_window_s, max_batch=max_batch))
    return BrTPFApp(AsyncBrTPFServer.from_config(
        store, config, batch_window_s=batch_window_s,
        max_batch=max_batch, cache=cache))


def run_app(app: BrTPFApp, host: str = "127.0.0.1",
            port: int = 8000, **uvicorn_kwargs) -> None:
    """Serve the app with uvicorn (an optional dependency of the port).
    Import is gated so the rest of the serving edge -- TestClient,
    transports, the router -- works without it."""
    try:
        import uvicorn
    except ImportError as exc:  # pragma: no cover - env without extras
        raise RuntimeError(
            "uvicorn is not installed; install uvicorn to serve over a "
            "real socket (the in-process TestClient and transports work "
            "without it)") from exc
    uvicorn.run(app, host=host, port=port, **uvicorn_kwargs)


# ---------------------------------------------------------------------------
# In-process test client
# ---------------------------------------------------------------------------


class TestResponse:
    """Minimal response surface (status_code / headers / content /
    json()), shaped after ``starlette.testclient`` responses."""

    __test__ = False  # library class, not a pytest collection target

    def __init__(self, status_code: int,
                 headers: List[Tuple[bytes, bytes]],
                 content: bytes) -> None:
        self.status_code = status_code
        self.headers = {k.decode("latin-1"): v.decode("latin-1")
                        for k, v in headers}
        self.content = content

    def json(self):
        return json.loads(self.content.decode("utf-8"))


async def request_asgi(app, method: str, path: str,
                       params: Optional[dict] = None,
                       body: Optional[bytes] = None) -> TestResponse:
    """Drive one request through an ASGI app inside the running loop
    (the transport layer and concurrent load generators call this
    directly; the sync :class:`TestClient` wraps it)."""
    from urllib.parse import urlencode
    query = urlencode(params or {}, doseq=True)
    scope = {
        "type": "http",
        "asgi": {"version": "3.0"},
        "http_version": "1.1",
        "method": method,
        "scheme": "http",
        "path": path,
        "raw_path": path.encode("utf-8"),
        "query_string": query.encode("utf-8"),
        "headers": _JSON_HEADERS if body is not None else [],
        "client": ("testclient", 50000),
        "server": ("testserver", 80),
    }
    sent = {"body": body or b"", "done": body is None}
    messages: List[dict] = []

    async def receive():
        if sent["done"]:
            return {"type": "http.disconnect"}
        sent["done"] = True
        return {"type": "http.request", "body": sent["body"],
                "more_body": False}

    async def send(message):
        messages.append(message)

    await app(scope, receive, send)
    status, headers, chunks = 500, [], []
    for message in messages:
        if message["type"] == "http.response.start":
            status = message["status"]
            headers = list(message.get("headers", []))
        elif message["type"] == "http.response.body":
            chunks.append(message.get("body", b""))
    return TestResponse(status, headers, b"".join(chunks))


class TestClient:
    """Synchronous in-process client for :class:`BrTPFApp`.

    Owns ONE event loop for its lifetime: the async front end behind
    the app binds its locks/timers to the first loop that touches them,
    so every request must run on the same loop (what starlette's
    TestClient achieves with a portal thread).
    """

    __test__ = False  # library class, not a pytest collection target

    def __init__(self, app) -> None:
        self.app = app
        self._loop = asyncio.new_event_loop()

    def request(self, method: str, path: str,
                params: Optional[dict] = None,
                json_body: Optional[dict] = None) -> TestResponse:
        body = None if json_body is None else dumps(json_body)
        return self._loop.run_until_complete(
            request_asgi(self.app, method, path, params=params, body=body))

    def get(self, path: str, params: Optional[dict] = None) -> TestResponse:
        return self.request("GET", path, params=params)

    def post(self, path: str,
             json_body: Optional[dict] = None) -> TestResponse:
        return self.request("POST", path, json_body=json_body)

    def close(self) -> None:
        if not self._loop.is_closed():
            self._loop.run_until_complete(self.app.aclose())
            self._loop.close()

    def __enter__(self) -> "TestClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
