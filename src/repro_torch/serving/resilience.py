"""Client-side resilience: retries, backoff + jitter, hedging, deadlines.

Fragment requests are idempotent reads -- the response to (pattern,
Omega, page) is a pure function of the dataset -- so retrying them is
always safe; what needs care is retrying the *right* failures with the
*right* pacing:

* :func:`is_retryable` is the ONE predicate deciding what is transient
  (every retry loop must consult it): 503 admission control, transport
  5xx, timeouts/deadline expiries. 400/404/414 are the client's own
  fault and retrying them would loop forever.
* :class:`RetryPolicy` paces attempts with exponential backoff and FULL
  jitter (``uniform(0, min(cap, base * 2^attempt))``): under a
  correlated failure (a replica stalls, a queue saturates) full jitter
  de-synchronizes the retry herd, while a ``retry_after_ms`` hint from
  the server (one batching window on 503) floors the pause.
* Hedging cuts tail latency: once enough latency samples exist, a
  second identical request is fired after the observed p95 and the
  first response wins. brTPF fragments are cheap and idempotent, so the
  cost of a duplicate is one wasted page -- the classic "tied requests"
  trade.
* Deadlines: the policy (or the caller, via ``Request.timeout_ms``)
  fixes a total per-request budget; every attempt is stamped with the
  REMAINING budget, so the server's deadline-aware shedding
  (core/batching.py) and the transports' bounded awaits see exactly how
  much patience the client has left.

All counters surface through ``metrics()`` as the ``"resilience"``
section of the canonical snapshot (core/metrics.py
``resilience_section``).
"""
from __future__ import annotations

import asyncio
import dataclasses
import random
import time
from collections import deque
from typing import Optional

from ..core.batching import DeadlineExceeded, QueueSaturated
from ..core.metrics import resilience_section
from .transport import TransportError

# Transport statuses worth retrying even without a retryable flag on
# the envelope: transient server/gateway conditions on an idempotent GET.
RETRYABLE_STATUSES = (408, 500, 502, 503, 504)


def is_retryable(exc: BaseException) -> bool:
    """Central retry predicate (docs/resilience.md).

    Retryable: admission-control 503 (:class:`QueueSaturated`), deadline
    expiries (:class:`DeadlineExceeded` -- the NEXT attempt may hit a
    resident page or a healthy replica), timeouts, and transport errors
    that are flagged retryable or carry a transient 5xx/408 status.
    Everything else (malformed envelope, 414 maxMpR, client bugs) is
    permanent and must surface immediately.
    """
    if isinstance(exc, (QueueSaturated, DeadlineExceeded,
                        asyncio.TimeoutError)):
        return True
    if isinstance(exc, TransportError):
        return exc.retryable or exc.status in RETRYABLE_STATUSES
    return False


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Pacing knobs for :class:`ResilientTransport`.

    ``deadline_ms`` is the default per-request budget applied when the
    request itself carries none; ``None`` means unbounded (retries still
    stop at ``max_attempts``). ``attempt_timeout_ms`` caps what ONE
    attempt may burn of that budget: against a stalled replica it is
    the difference between "first attempt eats the whole deadline" and
    "fail fast, feed the breaker, retry elsewhere with budget to
    spare". ``hedge_after_s`` pins the hedge delay;
    when ``None`` it is derived as the p95 of observed latencies once
    ``hedge_min_samples`` have been collected (no hedging before that
    -- a cold client has no tail to cut).
    """

    max_attempts: int = 4
    base_backoff_s: float = 0.005
    max_backoff_s: float = 0.25
    deadline_ms: Optional[float] = None
    attempt_timeout_ms: Optional[float] = None
    hedge: bool = False
    hedge_after_s: Optional[float] = None
    hedge_min_samples: int = 32

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 (or None)")
        if (self.attempt_timeout_ms is not None
                and self.attempt_timeout_ms <= 0):
            raise ValueError("attempt_timeout_ms must be > 0 (or None)")
        if self.hedge_min_samples < 1:
            raise ValueError("hedge_min_samples must be >= 1")

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter exponential backoff for the given (1-based)
        failed-attempt count."""
        cap = min(self.max_backoff_s,
                  self.base_backoff_s * (2 ** (attempt - 1)))
        return rng.uniform(0.0, cap)


@dataclasses.dataclass
class ResilienceStats:
    attempts: int = 0
    retries: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    deadline_exceeded: int = 0
    giveups: int = 0


class ResilientTransport:
    """Retry/hedge/deadline wrapper around any transport.

    Stacks on :class:`~repro_torch.serving.transport.LoopbackTransport`,
    :class:`~repro_torch.serving.transport.AsgiTransport` or a fault-injecting
    wrapper, and presents the same transport surface, so
    :class:`~repro_torch.core.client.AsyncBrTPFClient` plugs in unchanged.
    ``seed`` makes the jitter stream reproducible for tests/benchmarks.
    """

    LATENCY_WINDOW = 512

    def __init__(self, inner, policy: Optional[RetryPolicy] = None,
                 seed: int = 0) -> None:
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.stats = ResilienceStats()
        self._rng = random.Random(seed)
        self._samples = deque(maxlen=self.LATENCY_WINDOW)

    @property
    def max_mpr(self) -> int:
        return self.inner.max_mpr

    # -- request path --------------------------------------------------------

    async def handle(self, req):
        budget_ms = (req.timeout_ms if req.timeout_ms is not None
                     else self.policy.deadline_ms)
        deadline = (None if budget_ms is None
                    else time.monotonic() + budget_ms / 1e3)
        failures = 0
        while True:
            remaining_s = (None if deadline is None
                           else deadline - time.monotonic())
            if remaining_s is not None and remaining_s <= 0:
                self.stats.deadline_exceeded += 1
                raise DeadlineExceeded(
                    f"client budget of {budget_ms:.1f}ms exhausted "
                    f"after {failures} failed attempt(s)")
            attempt_ms = (None if remaining_s is None
                          else remaining_s * 1e3)
            cap = self.policy.attempt_timeout_ms
            if cap is not None:
                attempt_ms = cap if attempt_ms is None \
                    else min(attempt_ms, cap)
            stamped = (req if attempt_ms is None else
                       dataclasses.replace(req, timeout_ms=attempt_ms))
            self.stats.attempts += 1
            try:
                return await self._attempt(stamped, remaining_s)
            except Exception as exc:
                if not is_retryable(exc):
                    raise
                failures += 1
                if failures >= self.policy.max_attempts:
                    self.stats.giveups += 1
                    raise
                self.stats.retries += 1
                pause = self.policy.backoff_s(failures, self._rng)
                hint = getattr(exc, "retry_after_ms", None)
                if hint:
                    pause = max(pause, hint / 1e3)
                if remaining_s is not None:
                    pause = min(pause, remaining_s)
                if pause > 0:
                    await asyncio.sleep(pause)

    async def _attempt(self, req, remaining_s: Optional[float]):
        """One timed attempt (possibly hedged); successes feed the
        latency window the hedge delay derives from."""
        t0 = time.perf_counter()
        delay = self._hedge_delay_s()
        if delay is None:
            frag = await self.inner.handle(req)
        else:
            frag = await self._hedged(req, delay)
        self._samples.append(time.perf_counter() - t0)
        return frag

    async def _hedged(self, req, delay_s: float):
        """Primary attempt; if it is still unresolved after ``delay_s``
        fire an identical hedge and take whichever answers first (first
        *success* wins; a failure waits for the slower sibling before
        surfacing). Losers are cancelled -- an abandoned hedge must not
        keep a replica busy."""
        primary = asyncio.ensure_future(self.inner.handle(req))
        tasks = {primary}
        try:
            done, _ = await asyncio.wait({primary}, timeout=delay_s)
            if primary in done:
                return await primary  # already resolved: result or raise
            self.stats.hedges += 1
            backup = asyncio.ensure_future(self.inner.handle(req))
            tasks.add(backup)
            last_exc: Optional[BaseException] = None
            waiting = set(tasks)
            while waiting:
                done, waiting = await asyncio.wait(
                    waiting, return_when=asyncio.FIRST_COMPLETED)
                for task in done:
                    if task.exception() is None:
                        if task is backup:
                            self.stats.hedge_wins += 1
                        return await task  # done: yields the fragment
                    last_exc = task.exception()
            assert last_exc is not None
            raise last_exc
        finally:
            for task in tasks:
                if not task.done():
                    task.cancel()
            for task in tasks:
                if not task.done():
                    try:
                        await task
                    except (Exception, asyncio.CancelledError):
                        pass

    def _hedge_delay_s(self) -> Optional[float]:
        if not self.policy.hedge:
            return None
        if self.policy.hedge_after_s is not None:
            return self.policy.hedge_after_s
        if len(self._samples) < self.policy.hedge_min_samples:
            return None
        ordered = sorted(self._samples)
        idx = min(len(ordered) - 1, int(0.95 * len(ordered)))
        return ordered[idx]

    # -- observability / lifecycle -------------------------------------------

    async def metrics(self) -> dict:
        """The inner snapshot with this client's retry/hedge counters
        overlaid on its ``"resilience"`` section (server-side ``shed``
        and router ``breaker`` numbers pass through untouched)."""
        snap = await self.inner.metrics()
        section = snap.setdefault("resilience", resilience_section())
        section["retries"] = (section.get("retries", 0)
                              + self.stats.retries)
        section["hedges"] = section.get("hedges", 0) + self.stats.hedges
        section["hedge_wins"] = (section.get("hedge_wins", 0)
                                 + self.stats.hedge_wins)
        section["deadline_exceeded"] = (
            section.get("deadline_exceeded", 0)
            + self.stats.deadline_exceeded)
        section["giveups"] = (section.get("giveups", 0)
                              + self.stats.giveups)
        return snap

    async def aclose(self) -> None:
        await self.inner.aclose()
