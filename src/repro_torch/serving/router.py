"""Front-end replica router: one edge, N origin-server replicas.

The ROADMAP's "millions of users" item needs more than one origin
process behind the wire. :class:`ReplicaRouter` owns N replicas -- each
a :class:`~repro_torch.core.server.BrTPFServer` built from the SAME
:class:`~repro_torch.core.config.ServerConfig`, wrapped in its own
:class:`~repro_torch.core.batching.AsyncBrTPFServer` batching window -- over
one shared :class:`~repro_torch.core.store.TripleStore` (the dataset is one
HDT image; what a replica owns privately is its unified
:class:`~repro_torch.core.fragments.FragmentStore` and its batching queue).

Routing policies:

* ``"pattern"`` (default) -- **fragment affinity**: a stable hash of
  the triple pattern pins every request for a pattern to one replica,
  the same way :meth:`~repro_torch.core.federation.FederatedStore.plan_windows`
  pins window pages to the shard that owns their key range. Affinity is
  what makes a replica's fragment store *converge*: repeat requests for
  a pattern always land where its fragments are resident, so the
  launches-skipped rate of a fleet matches a single server's instead of
  dividing by N.
* ``"round_robin"`` -- pure load spreading; each replica sees 1/N of
  every pattern, which maximizes batching-window mixing but fragments
  residency. Kept as the baseline the affinity policy is measured
  against.

Health-gated failover (docs/resilience.md): each replica sits behind a
:class:`CircuitBreaker`. Affinity gives the *preferred* replica; when
its breaker is open the request degrades to the next healthy replica in
``(preferred + k) % n`` order instead of failing -- trading fragment
residency for availability, exactly the brTPF availability argument.
A stalled replica is detected through the client's own deadline: the
bounded await cancels the in-flight ``handle``, the router counts the
cancellation as a replica failure, and enough consecutive failures open
the breaker. After ``reset_after_s`` one half-open probe is admitted;
success re-closes the breaker, failure re-opens it.

The router presents the same async backend surface as a single front
end (``handle`` / ``metrics_snapshot`` / ``note_mappings`` / ``max_mpr``
/ ``aclose``), so :class:`~repro_torch.serving.http.BrTPFApp` and both
transports work unchanged over a fleet; ``metrics_snapshot`` merges the
replicas' counters into the canonical schema with per-replica detail
under ``"replicas"`` and breaker/shed accounting under
``"resilience"``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import List, Optional, Tuple

from ..core.batching import (DEFAULT_BATCH_WINDOW_S, DEFAULT_MAX_BATCH,
                             AsyncBrTPFServer)
from ..core.config import ServerConfig
from ..core.metrics import METRICS_VERSION, Counters, resilience_section
from ..core.selectors import Fragment
from ..core.server import MaxMprExceeded, Request
from ..core.wire import WireError
from .faults import FaultyBackend

POLICIES = ("pattern", "round_robin")

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

DEFAULT_FAILURE_THRESHOLD = 5
DEFAULT_RESET_AFTER_S = 1.0


def stable_replica_index(pattern_tuple: Tuple[int, int, int],
                         n: int) -> int:
    """Deterministic pattern -> replica assignment (process-independent,
    unlike ``hash()``): an FNV-1a mix over the three components."""
    acc = 0x811C9DC5
    for c in pattern_tuple:
        acc = ((acc ^ (c & 0xFFFFFFFF)) * 0x01000193) & 0xFFFFFFFF
    return acc % n


class CircuitBreaker:
    """Per-replica consecutive-failure breaker (docs/resilience.md).

    closed -> open after ``failure_threshold`` consecutive failures;
    open -> half-open after ``reset_after_s`` (the next ``allow()``
    admits ONE probe); half-open -> closed on probe success, -> open on
    probe failure. ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
                 reset_after_s: float = DEFAULT_RESET_AFTER_S,
                 clock=time.monotonic) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_after_s <= 0:
            raise ValueError("reset_after_s must be > 0")
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self.state = BREAKER_CLOSED
        self.transitions = 0   # every state change
        self.opens = 0         # transitions INTO open
        self._consecutive = 0
        self._opened_at = 0.0

    def allow(self) -> bool:
        """May a request be sent to this replica right now? Open
        breakers flip to half-open (admitting this one probe) once the
        reset window has elapsed; a half-open breaker admits nothing
        further until the in-flight probe resolves."""
        if self.state == BREAKER_CLOSED:
            return True
        if (self.state == BREAKER_OPEN
                and self._clock() - self._opened_at >= self.reset_after_s):
            self._transition(BREAKER_HALF_OPEN)
            return True
        return False

    def record_success(self) -> None:
        self._consecutive = 0
        if self.state != BREAKER_CLOSED:
            self._transition(BREAKER_CLOSED)

    def record_failure(self) -> None:
        self._consecutive += 1
        if self.state == BREAKER_HALF_OPEN or (
                self.state == BREAKER_CLOSED
                and self._consecutive >= self.failure_threshold):
            self._transition(BREAKER_OPEN)
            self.opens += 1
            self._opened_at = self._clock()

    def _transition(self, state: str) -> None:
        self.state = state
        self.transitions += 1

    def snapshot(self) -> dict:
        return {"state": self.state, "transitions": self.transitions,
                "opens": self.opens,
                "consecutive_failures": self._consecutive}


@dataclasses.dataclass
class RouterStats:
    requests: int = 0
    failovers: int = 0       # served off the preferred replica
    replica_failures: int = 0  # infra failures charged to a breaker
    per_replica: List[int] = dataclasses.field(default_factory=list)


class ReplicaRouter:
    """Fan requests across N async server replicas (shared store)."""

    def __init__(self, store, config: Optional[ServerConfig] = None, *,
                 replicas: int = 2, policy: str = "pattern",
                 batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
                 reset_after_s: float = DEFAULT_RESET_AFTER_S,
                 fault_plan=None) -> None:
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}")
        self.config = config or ServerConfig()
        self.policy = policy
        self.batch_window_s = float(batch_window_s)
        backends = [
            AsyncBrTPFServer.from_config(store, self.config,
                                         batch_window_s=batch_window_s,
                                         max_batch=max_batch)
            for _ in range(replicas)]
        if fault_plan is not None:
            # seeded chaos (serving/faults.py): wrap each replica in its
            # deterministic fault schedule -- behind the router, so the
            # breaker/failover machinery sees exactly these failures
            backends = [FaultyBackend(b, fault_plan.for_replica(i))
                        for i, b in enumerate(backends)]
        self.replicas = backends
        self.breakers = [CircuitBreaker(failure_threshold,
                                        reset_after_s)
                         for _ in range(replicas)]
        self.stats = RouterStats(per_replica=[0] * replicas)
        self._rr = 0

    @property
    def max_mpr(self) -> int:
        return self.config.max_mpr

    # -- routing -------------------------------------------------------------

    def route(self, req: Request) -> int:
        """Preferred replica index for a request (non-advancing for
        affinity; advances the round-robin pointer)."""
        if self.policy == "pattern":
            return stable_replica_index(req.pattern.as_tuple(),
                                        len(self.replicas))
        idx = self._rr
        self._rr = (self._rr + 1) % len(self.replicas)
        return idx

    def _pick(self, preferred: int) -> int:
        """Health gate: the preferred replica if its breaker admits,
        else the next healthy one in ``(preferred + k) % n`` order; if
        every breaker refuses, fail fast on the preferred (its error
        keeps feeding the breaker that will eventually half-open)."""
        n = len(self.replicas)
        for k in range(n):
            cand = (preferred + k) % n
            if self.breakers[cand].allow():
                return cand
        return preferred

    def note_mappings(self, req: Request) -> None:
        """Wire-boundary mappings accounting; attributed to the replica
        the pattern is pinned to (round-robin attribution lands on the
        current pointer -- the merged counters are exact either way)."""
        if self.policy == "pattern":
            idx = stable_replica_index(req.pattern.as_tuple(),
                                       len(self.replicas))
        else:
            idx = self._rr
        self.replicas[idx].note_mappings(req)

    async def handle(self, req: Request) -> Fragment:
        preferred = self.route(req)
        idx = self._pick(preferred)
        if idx != preferred:
            self.stats.failovers += 1
        self.stats.requests += 1
        self.stats.per_replica[idx] += 1
        breaker = self.breakers[idx]
        try:
            frag = await self.replicas[idx].handle(req)
        except asyncio.CancelledError:
            # the caller's deadline cancelled a still-pending await --
            # the signature of a stalled replica; charge the breaker
            # before propagating the cancellation
            breaker.record_failure()
            self.stats.replica_failures += 1
            raise
        except (MaxMprExceeded, WireError):
            # the CLIENT's fault -- says nothing about replica health
            raise
        except Exception:
            breaker.record_failure()
            self.stats.replica_failures += 1
            raise
        breaker.record_success()
        return frag

    async def aclose(self) -> None:
        await asyncio.gather(*[front.aclose() for front in self.replicas])

    # -- observability -------------------------------------------------------

    def breaker_section(self) -> dict:
        """The ``"breaker"`` sub-section of the resilience metrics."""
        return {
            "states": [b.state for b in self.breakers],
            "transitions": sum(b.transitions for b in self.breakers),
            "opens": sum(b.opens for b in self.breakers),
            "open_now": sum(1 for b in self.breakers
                            if b.state != BREAKER_CLOSED),
            "failovers": self.stats.failovers,
            "replica_failures": self.stats.replica_failures,
        }

    def metrics_snapshot(self) -> dict:
        """Merged canonical snapshot: fleet-total counters and layer
        sums at the top level (same keys as a single server's
        ``metrics_snapshot``), per-replica envelopes under
        ``"replicas"``, breaker + summed shed under ``"resilience"``."""
        merged = Counters()
        snaps = [front.metrics_snapshot() for front in self.replicas]
        for front in self.replicas:
            merged.merge(front.server.counters)
        out = {
            "v": METRICS_VERSION,
            "counters": dataclasses.asdict(merged),
            "launches_skipped": sum(
                s["launches_skipped"] for s in snaps),
            "selector_memo": _sum_layer(snaps, "selector_memo"),
            "range_memo": _sum_layer(snaps, "range_memo"),
            "router": {
                "policy": self.policy,
                "replicas": len(self.replicas),
                "requests": self.stats.requests,
                "requests_per_replica": list(self.stats.per_replica),
            },
            "resilience": resilience_section(
                shed=sum(s.get("resilience", {}).get("shed", 0)
                         for s in snaps),
                breaker=self.breaker_section()),
            "replicas": snaps,
        }
        faults = [getattr(front, "faults", None) for front in self.replicas]
        if any(f is not None for f in faults):
            out["faults"] = [f.summary() if f is not None else None
                             for f in faults]
        if any("http" in s for s in snaps):
            out["http"] = _sum_layer([s for s in snaps if "http" in s],
                                     "http")
        return out


def _sum_layer(snaps: List[dict], layer: str) -> dict:
    hits = sum(s[layer]["hits"] for s in snaps)
    misses = sum(s[layer]["misses"] for s in snaps)
    out = {"hits": hits, "misses": misses,
           "hit_rate": hits / max(hits + misses, 1)}
    if all("entries" in s[layer] for s in snaps):
        out["entries"] = sum(s[layer]["entries"] for s in snaps)
    return out
