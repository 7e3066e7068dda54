"""Client-side transports speaking the brtpf/v1 wire schema.

A transport is what :class:`~repro_torch.core.client.AsyncBrTPFClient` plugs
into instead of a raw ``AsyncBrTPFServer``: anything with
``async handle(Request) -> Fragment``, ``async metrics() -> dict``,
``max_mpr`` and ``async aclose()``. Two implementations:

* :class:`LoopbackTransport` -- in-process, but every request and
  response round-trips through the SAME brtpf/v1 envelope serialization
  the HTTP path uses (``core/wire.py``: ``to_wire -> bytes ->
  from_wire`` both ways). It is the parity anchor: if the HTTP path and
  the loopback path disagree, the bug is in the transport, not the
  schema -- and it is what the CI-gated ``loopback:*`` latency budgets
  measure, because it prices the serialization boundary without socket
  noise.
* :class:`AsgiTransport` -- drives a :class:`~repro_torch.serving.http.BrTPFApp`
  through real ASGI messages (``POST /fragment``), fully in-process but
  through the complete HTTP layer: status codes (414 ->
  :class:`~repro_torch.core.server.MaxMprExceeded`), headers, body framing.
  Point :func:`repro_torch.serving.http.run_app` at the same app and the
  identical bytes go over a socket.

Both charge ``mappings_sent`` at the wire boundary via the backend's
``note_mappings`` -- the in-process client path charges it client-side,
so the two never double-count.

Deadline semantics are identical across the two (docs/resilience.md):
a request carrying ``timeout_ms`` bounds the await on the backend with
that budget, and expiry surfaces as
:class:`~repro_torch.core.batching.DeadlineExceeded` on either path -- whether
the budget ran out client-side (the bounded await fired) or server-side
(the batching front end shed the request / the ASGI app answered 504).
Retryability travels on :class:`TransportError` (``retryable`` /
``code`` / ``retry_after_ms``, decoded from the error envelope), which
is what the central ``is_retryable()`` predicate in
``serving/resilience.py`` consults.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ..core.batching import DeadlineExceeded
from ..core.selectors import Fragment
from ..core.server import MaxMprExceeded, Request
from ..core.wire import (WireError, dumps, error_from_wire,
                         fragment_from_wire, fragment_to_wire, loads,
                         request_from_wire, request_to_wire)
from .http import BrTPFApp, request_asgi


class TransportError(RuntimeError):
    """Non-414 HTTP failure surfaced by a transport.

    ``retryable`` / ``code`` / ``retry_after_ms`` carry the error
    envelope's resilience fields (core/wire.py ``error_to_wire``) so the
    retry policy can branch on the condition, not on message text.
    """

    def __init__(self, status: int, message: str,
                 retryable: bool = False, code: Optional[str] = None,
                 retry_after_ms: Optional[float] = None) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.retryable = retryable
        self.code = code
        self.retry_after_ms = retry_after_ms


async def _bounded(awaitable, timeout_ms: Optional[float]):
    """Await with the request's remaining deadline budget (if any);
    expiry raises :class:`DeadlineExceeded` -- the one deadline
    implementation both transports share, so loopback and ASGI cannot
    drift."""
    if timeout_ms is None:
        return await awaitable
    try:
        return await asyncio.wait_for(awaitable, timeout_ms / 1e3)
    except asyncio.TimeoutError:
        raise DeadlineExceeded(
            f"no response within timeout_ms={timeout_ms:.1f}") from None


class LoopbackTransport:
    """In-process transport over an ``AsyncBrTPFServer`` (or a
    ``ReplicaRouter``) with full wire-envelope round-trips."""

    def __init__(self, front) -> None:
        self.front = front

    @property
    def max_mpr(self) -> int:
        return self.front.max_mpr

    async def handle(self, req: Request) -> Fragment:
        # serialize -> bytes -> parse: the request the origin sees is
        # exactly what an HTTP server would have decoded
        wire_req = request_from_wire(loads(dumps(request_to_wire(req))))
        self.front.note_mappings(wire_req)
        frag = await _bounded(self.front.handle(wire_req),
                              wire_req.timeout_ms)  # MaxMprExceeded raises
        return fragment_from_wire(loads(dumps(fragment_to_wire(frag))))

    async def metrics(self) -> dict:
        return loads(dumps(self.front.metrics_snapshot()))

    async def aclose(self) -> None:
        await self.front.aclose()


class AsgiTransport:
    """Transport over a :class:`~repro_torch.serving.http.BrTPFApp` via real
    ASGI request/response messages (the HTTP path minus the socket)."""

    def __init__(self, app: BrTPFApp) -> None:
        self.app = app

    @property
    def max_mpr(self) -> int:
        return self.app.max_mpr

    async def handle(self, req: Request) -> Fragment:
        resp = await _bounded(
            request_asgi(self.app, "POST", "/fragment",
                         body=dumps(request_to_wire(req))),
            req.timeout_ms)
        if resp.status_code == 200:
            return fragment_from_wire(loads(resp.content))
        err = _error_fields(resp)
        message = err["error"]
        if resp.status_code == 414:
            raise MaxMprExceeded(message)
        if resp.status_code == 400:
            raise WireError(message)
        if resp.status_code == 504 or err["code"] == "DEADLINE_EXCEEDED":
            # server-side shed: same exception type as a client-side
            # expiry, so callers see ONE deadline condition
            raise DeadlineExceeded(message)
        raise TransportError(resp.status_code, message,
                             retryable=err["retryable"],
                             code=err["code"],
                             retry_after_ms=err["retry_after_ms"])

    async def metrics(self) -> dict:
        resp = await request_asgi(self.app, "GET", "/metrics")
        if resp.status_code != 200:
            raise TransportError(resp.status_code,
                                 _error_fields(resp)["error"])
        return loads(resp.content)

    async def aclose(self) -> None:
        await self.app.aclose()


def _error_fields(resp) -> dict:
    """Best-effort decode of an error response body into the normalized
    ``error_from_wire`` dict; a non-envelope body (proxy HTML, truncated
    bytes) degrades to a message-only dict instead of masking the
    original HTTP failure with a WireError."""
    try:
        return error_from_wire(loads(resp.content))
    except WireError:
        return {"status": resp.status_code,
                "error": resp.content.decode("utf-8", "replace"),
                "retryable": False, "code": None, "retry_after_ms": None}
