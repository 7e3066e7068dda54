"""Deterministic, seeded fault injection for the serving stack.

The brTPF argument is about server availability under load; to *test*
availability you must be able to make servers fail on demand, the same
way every run. A :class:`FaultPlan` is a seeded, per-replica schedule of
failure modes:

* ``delay_s`` -- add fixed latency to every request (slow replica);
* ``error_rate`` -- fail that fraction of requests with a transport
  error (``error_status``, default 503 retryable);
* ``drop_rate`` -- swallow that fraction: the backend never answers
  within any finite deadline (modeled as an un-cancelled stall, so only
  a client deadline gets the caller out);
* ``stall_after`` / ``stall_s`` -- after K served requests, every
  subsequent request hangs for ``stall_s`` before being served (a
  wedged replica: the client's deadline expires first, and repeated
  expiries open the router's circuit breaker);
* ``crash_after`` -- after K served requests, every subsequent request
  fails hard with a non-retryable-looking 500 (a dead replica).

Determinism: each replica draws from its own ``random.Random`` seeded
as ``seed * 1000003 + replica``, and decisions are made per *perturb
call* in arrival order -- so a (plan seed, request order) pair replays
the identical fault sequence in tests, benchmarks and CI, and the same
sequence as the JAX package's ``repro.serving.faults`` (this module is
its port; the draws are made in the same order).

Three injection points wrap the three layers of the stack with the same
:class:`ReplicaFaults` schedule:

* :class:`FaultyBackend` wraps an async backend (a replica inside
  :class:`~repro_torch.serving.router.ReplicaRouter`, via its ``fault_plan``
  argument) -- faults *behind* the router, which is what the breaker
  and failover logic see;
* :class:`FaultyTransport` wraps a client-side transport -- faults on
  the path, which is what retry/backoff sees;
* :class:`FaultyApp` wraps the ASGI app -- faults at the HTTP edge,
  answered as proper brtpf/v1 error envelopes, which is what the
  AsgiTransport error decoding sees.

Closing a wrapper (``aclose``) cancels the requests it still holds in
an injected sleep, so a stalled replica never holds up a shutdown.
"""
from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Dict, Optional

from ..core.wire import dumps, error_to_wire
from .transport import TransportError


class InjectedFault(TransportError):
    """A failure manufactured by a :class:`FaultPlan` (subclasses
    :class:`TransportError` so client code cannot tell it from a real
    one -- that is the point)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One replica's failure schedule. The default instance is a no-op."""

    delay_s: float = 0.0
    error_rate: float = 0.0
    error_status: int = 503
    drop_rate: float = 0.0
    stall_after: Optional[int] = None
    stall_s: float = 30.0
    crash_after: Optional[int] = None

    def __post_init__(self) -> None:
        for name in ("error_rate", "drop_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.delay_s < 0 or self.stall_s < 0:
            raise ValueError("delay_s/stall_s must be >= 0")
        for name in ("stall_after", "crash_after"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0 (or None)")

    @property
    def is_noop(self) -> bool:
        return (self.delay_s == 0 and self.error_rate == 0
                and self.drop_rate == 0 and self.stall_after is None
                and self.crash_after is None)


@dataclasses.dataclass
class FaultStats:
    calls: int = 0
    delays: int = 0
    errors: int = 0
    drops: int = 0
    stalls: int = 0
    crashes: int = 0


class ReplicaFaults:
    """One replica's live fault state: the spec plus its seeded RNG and
    served-request counter. ``perturb()`` is awaited before the real
    handler runs; it either returns (possibly after sleeping) or raises
    :class:`InjectedFault`."""

    # a drop is "never answers": long enough that only a deadline ends
    # the wait, short enough that a test without deadlines still ends
    DROP_STALL_S = 600.0

    def __init__(self, spec: FaultSpec, seed: int) -> None:
        self.spec = spec
        self.seed = seed
        self.rng = random.Random(seed)
        self.stats = FaultStats()
        # tasks held in an injected sleep (stall, drop or delay), so that
        # closing the replica can release them at once
        self._sleeping: set = set()

    async def _sleep(self, seconds: float) -> None:
        task = asyncio.current_task()
        self._sleeping.add(task)
        try:
            await asyncio.sleep(seconds)
        finally:
            self._sleeping.discard(task)

    def cancel_pending(self) -> None:
        """Cancel every request still held in an injected sleep: a
        replica being closed must not keep its callers waiting out a
        30 s stall or a drop."""
        for task in list(self._sleeping):
            task.cancel()

    async def perturb(self) -> None:
        spec = self.spec
        self.stats.calls += 1
        served = self.stats.calls
        if (spec.crash_after is not None
                and served > spec.crash_after):
            self.stats.crashes += 1
            raise InjectedFault(500, f"injected crash (seed={self.seed}, "
                                     f"after {spec.crash_after} served)",
                                code="INTERNAL")
        if spec.drop_rate and self.rng.random() < spec.drop_rate:
            self.stats.drops += 1
            await self._sleep(self.DROP_STALL_S)
            return
        if (spec.stall_after is not None
                and served > spec.stall_after):
            self.stats.stalls += 1
            await self._sleep(spec.stall_s)
        if spec.error_rate and self.rng.random() < spec.error_rate:
            self.stats.errors += 1
            raise InjectedFault(
                spec.error_status,
                f"injected error (seed={self.seed})",
                retryable=spec.error_status in (500, 502, 503, 504),
                code=("QUEUE_SATURATED" if spec.error_status == 503
                      else "INTERNAL"))
        if spec.delay_s:
            self.stats.delays += 1
            await self._sleep(spec.delay_s)

    def summary(self) -> dict:
        return dataclasses.asdict(self.stats)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fleet-wide fault schedule: ``default`` applies to every
    replica without an entry in ``per_replica``. Frozen so a plan can be
    shared across the A/B arms of a chaos run; live state lives in the
    :class:`ReplicaFaults` handed out by :meth:`for_replica`."""

    seed: int = 0
    default: FaultSpec = FaultSpec()
    per_replica: Dict[int, FaultSpec] = dataclasses.field(
        default_factory=dict)

    def spec_for(self, replica: int) -> FaultSpec:
        return self.per_replica.get(replica, self.default)

    def for_replica(self, replica: int) -> ReplicaFaults:
        # distinct, deterministic stream per replica: two replicas with
        # the same spec still fail on different requests
        return ReplicaFaults(self.spec_for(replica),
                             seed=self.seed * 1000003 + replica)


class FaultyBackend:
    """Wrap an async backend (``AsyncBrTPFServer`` or compatible) so
    every ``handle`` is perturbed first. Everything else (metrics,
    ``note_mappings``, ``max_mpr``, ``aclose``, ``server`` ...)
    delegates to the wrapped backend unchanged."""

    def __init__(self, inner, faults: ReplicaFaults) -> None:
        self.inner = inner
        self.faults = faults

    async def handle(self, req):
        await self.faults.perturb()
        return await self.inner.handle(req)

    async def aclose(self) -> None:
        self.faults.cancel_pending()
        await self.inner.aclose()

    def __getattr__(self, name):
        return getattr(self.inner, name)


class FaultyTransport:
    """Wrap a client-side transport (Loopback/Asgi/Resilient) the same
    way -- the injection point for client-path faults."""

    def __init__(self, inner, faults: ReplicaFaults) -> None:
        self.inner = inner
        self.faults = faults

    @property
    def max_mpr(self) -> int:
        return self.inner.max_mpr

    async def handle(self, req):
        await self.faults.perturb()
        return await self.inner.handle(req)

    async def metrics(self) -> dict:
        return await self.inner.metrics()

    async def aclose(self) -> None:
        self.faults.cancel_pending()
        await self.inner.aclose()


class FaultyApp:
    """ASGI middleware injecting faults at the HTTP edge: an injected
    fault becomes a real brtpf/v1 error envelope with the fault's
    status, so the client-side decoding path (AsgiTransport ->
    ``error_from_wire`` -> TransportError) is exercised end to end.
    Only ``/fragment`` traffic is perturbed; ``/metrics`` stays clean so
    observability survives the chaos it is observing."""

    def __init__(self, app, faults: ReplicaFaults) -> None:
        self.app = app
        self.faults = faults

    def __getattr__(self, name):
        return getattr(self.app, name)

    async def aclose(self) -> None:
        self.faults.cancel_pending()
        await self.app.aclose()

    async def __call__(self, scope, receive, send) -> None:
        if (scope.get("type") == "http"
                and scope.get("path") == "/fragment"):
            try:
                await self.faults.perturb()
            except InjectedFault as exc:
                body = dumps(error_to_wire(exc.status, str(exc),
                                           retryable=exc.retryable,
                                           code=exc.code))
                await send({
                    "type": "http.response.start",
                    "status": exc.status,
                    "headers": [(b"content-type", b"application/json"),
                                (b"content-length",
                                 str(len(body)).encode("ascii"))],
                })
                await send({"type": "http.response.body", "body": body})
                return
        await self.app(scope, receive, send)
