"""Async batching front end for the combined TPF/brTPF server.

The paper evaluates the server under up to 64 *concurrent* clients
(section 6); the kernel backend's ``handle_batch`` makes N same-pattern
requests cost one grouped bind-join launch -- but only when a caller
hands them over as one pre-assembled list. This module closes
that gap: :class:`AsyncBrTPFServer` is an asyncio front end that
accumulates requests arriving within a configurable window
(``batch_window_s``), flushes early when ``max_batch`` requests are
pending, and dispatches every flush through ``handle_batch`` -- so the
cross-request coalescing the throughput simulation charges for
(``SimParams.batch_window_s``) is something the server actually does.

Flush semantics (documented contract, tested in tests/test_batching.py):

* A request is validated against maxMpR at *enqueue* time: an oversized
  request fails alone, immediately, and never enters a batch -- so one
  misbehaving client cannot poison the coalesced requests of others
  (``handle_batch`` itself stays atomic; the front end simply never
  feeds it an invalid member).
* A request whose page is already resident in the server's unified
  fragment store (HTTP-cached page or memo-resident fragment,
  ``BrTPFServer.page_resident``) is served immediately instead of
  waiting out the window: it launches nothing, so there is nothing to
  coalesce, and holding it would only add latency. Counted in
  ``BatchStats.fast_path``; responses/accounting identical to the
  batched path.
* The first pending request arms a flush timer for ``batch_window_s``
  seconds; the batch flushes when the timer fires or as soon as
  ``max_batch`` requests are pending, whichever comes first. Exactly one
  of the two flushes a given batch (the timer finds an empty queue after
  a flush-on-full and is a no-op).
* A flush atomically takes the pending queue; requests arriving while a
  flush is executing start a new batch with a fresh timer -- they are
  never silently appended to a batch whose kernel launch already ran.
* Responses resolve in enqueue order within a batch, and batches flush
  FIFO; every response is byte-identical to what a sequential
  ``BrTPFServer.handle`` call would have returned (``handle_batch``
  guarantees this; the paging/caching/transfer accounting is shared).

``batch_window_s <= 0`` degenerates to immediate per-request dispatch
(still through ``handle_batch`` so solo requests take the normal
``handle`` path inside it).
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import List, Optional, Sequence, Tuple

from .selectors import Fragment
from .server import BrTPFServer, Request

DEFAULT_BATCH_WINDOW_S = 2e-3
DEFAULT_MAX_BATCH = 64


class QueueSaturated(RuntimeError):
    """Admission control (docs/serving.md): the batching queue is full.

    Raised at enqueue time when ``queue_depth`` pending requests are
    already waiting for a flush. The condition is *retryable* -- the
    queue drains within a batching window -- so the ASGI app maps it to
    HTTP 503 with a ``retryable`` error envelope instead of buffering
    without bound."""


class DeadlineExceeded(RuntimeError):
    """Deadline-aware shedding (docs/resilience.md): the request's
    remaining ``timeout_ms`` budget expired before it could be served.

    Raised at enqueue time when the budget is already exhausted, and at
    flush time for requests that expired while waiting out the batching
    window -- shedding them keeps an expired request from burning space
    in a fused launch whose response nobody is waiting for. Retryable
    (the ASGI app maps it to HTTP 504 with code ``DEADLINE_EXCEEDED``):
    fragment requests are idempotent, and the *next* attempt may hit a
    now-resident page or a less loaded replica."""


@dataclasses.dataclass
class BatchStats:
    """Front-end accounting (kernel launch counts live on the wrapped
    server's :class:`~repro_torch.core.metrics.Counters`)."""

    requests: int = 0           # accepted into a batch
    rejected: int = 0           # failed validation at enqueue
    fast_path: int = 0          # served immediately: page already resident
    flushes: int = 0            # non-empty batches dispatched
    timer_flushes: int = 0      # ... because the window elapsed
    full_flushes: int = 0       # ... because max_batch was reached
    coalesced_requests: int = 0  # requests sharing a flush with >= 1 other
    max_batch_seen: int = 0
    shed: int = 0               # expired-deadline requests shed unserved

    @property
    def mean_batch(self) -> float:
        return self.requests / self.flushes if self.flushes else 0.0


class AsyncBrTPFServer:
    """Asyncio accumulation window in front of a :class:`BrTPFServer`.

    ``await handle(req)`` enqueues the request and resolves with its
    :class:`Fragment` when the batch it joined has been served. All
    callers must run on the same event loop.

    ``executor`` optionally runs ``handle_batch`` off-loop (e.g. a
    ``concurrent.futures.ThreadPoolExecutor``): the event loop then
    stays responsive during a flush, so requests really can arrive
    mid-flush (they start the next batch). With the default inline
    dispatch the loop blocks for the duration of the batch -- fine for
    benchmarks and tests.
    """

    def __init__(
        self,
        server: BrTPFServer,
        batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
        max_batch: int = DEFAULT_MAX_BATCH,
        executor=None,
        queue_depth: Optional[int] = None,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if queue_depth is not None and queue_depth < 1:
            raise ValueError("queue_depth must be >= 1 (or None)")
        self.server = server
        self.batch_window_s = float(batch_window_s)
        self.max_batch = int(max_batch)
        self.queue_depth = queue_depth
        self.stats = BatchStats()
        self._executor = executor
        self._pending: List[Tuple[Request, "asyncio.Future",
                                  Optional[float]]] = []
        self._timer: Optional[asyncio.TimerHandle] = None
        self._flush_lock = asyncio.Lock()
        self._closed = False

    @classmethod
    def from_config(cls, store, config=None,
                    batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
                    max_batch: int = DEFAULT_MAX_BATCH,
                    cache=None, executor=None,
                    queue_depth: Optional[int] = None
                    ) -> "AsyncBrTPFServer":
        """Build the wrapped origin server from a
        :class:`~repro_torch.core.config.ServerConfig` -- the construction
        path the ASGI app factory and the replica router share, so a
        whole fleet is provably configured from one value object.
        ``queue_depth`` defaults to the config's knob when not passed
        explicitly."""
        if queue_depth is None:
            queue_depth = getattr(config, "queue_depth", None)
        return cls(BrTPFServer(store, config, cache=cache),
                   batch_window_s=batch_window_s, max_batch=max_batch,
                   executor=executor, queue_depth=queue_depth)

    @property
    def max_mpr(self) -> int:
        """The wrapped server's maxMpR (the 414 bound a transport
        advertises)."""
        return self.server.max_mpr

    def note_mappings(self, req: Request) -> None:
        """Charge the request's attached solution mappings to the
        server's ``mappings_sent``. Called by the WIRE boundary
        (transport / ASGI app) -- in-process clients charge the counter
        themselves, so the two paths never double-count."""
        if req.omega is not None:
            self.server.counters.mappings_sent += int(req.omega.shape[0])

    def metrics_snapshot(self) -> dict:
        """The canonical metrics envelope (metrics.py) with this front
        end's flush/coalescing stats attached under ``"batch"``."""
        from .metrics import metrics_snapshot
        return metrics_snapshot(self.server, batch=self.stats)

    # -- request boundary ----------------------------------------------------

    async def handle(self, req: Request) -> Fragment:
        """Enqueue one page request; resolves with its fragment."""
        if self._closed:
            raise RuntimeError("AsyncBrTPFServer is closed")
        # Per-request validation: an oversized request fails alone, now,
        # and never joins a batch (handle_batch's atomic all-or-nothing
        # check therefore never rejects a coalesced batch).
        try:
            self.server.validate(req)
        except Exception:
            self.stats.rejected += 1
            raise
        # Deadline check at enqueue (docs/resilience.md): a request that
        # arrives with an exhausted budget is shed now -- nobody is
        # waiting for the response, so serving it would be pure waste.
        if req.timeout_ms is not None and req.timeout_ms <= 0:
            self.stats.shed += 1
            raise DeadlineExceeded(
                f"request arrived with exhausted deadline budget "
                f"(timeout_ms={req.timeout_ms})")
        # Unified-store fast path: a page that is already resident (an
        # HTTP-cached page or a memo-resident fragment) launches
        # nothing, so there is nothing to coalesce -- serve it now
        # instead of holding it for the batching window. Responses and
        # accounting are identical to the batched path (handle() serves
        # from the store either way); only the window latency is saved.
        # The flush lock serializes this handle() against handle_batch
        # (with an executor, a flush mutates server state off-loop).
        if self.server.page_resident(req):
            async with self._flush_lock:
                self.stats.fast_path += 1
                return self.server.handle(req)
        # Admission control (docs/serving.md): refuse instead of
        # buffering without bound -- the queue drains within one
        # batching window, so the client can retry after backoff.
        if (self.queue_depth is not None
                and len(self._pending) >= self.queue_depth):
            self.stats.rejected += 1
            raise QueueSaturated(
                f"batching queue full: {len(self._pending)} pending >= "
                f"queue_depth={self.queue_depth}")
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future" = loop.create_future()
        # Absolute expiry on the loop clock: checked again at flush, so
        # a request that spent its whole budget waiting out the batching
        # window is shed instead of joining the launch.
        expires = (None if req.timeout_ms is None
                   else loop.time() + req.timeout_ms / 1e3)
        self._pending.append((req, fut, expires))
        self.stats.requests += 1
        if self.batch_window_s <= 0 or len(self._pending) >= self.max_batch:
            cause = ("full" if len(self._pending) >= self.max_batch
                     else "inline")
            self._cancel_timer()
            await self._flush(cause)
        elif self._timer is None:
            self._timer = loop.call_later(self.batch_window_s,
                                          self._on_timer, loop)
        return await fut

    async def aclose(self) -> None:
        """Flush anything pending and refuse further requests."""
        self._closed = True
        self._cancel_timer()
        await self._flush("close")

    async def repartition(self, heat=None) -> None:
        """Atomic placement cutover (docs/federation.md, "Placement"):
        runs ``BrTPFServer.repartition`` under the flush lock, so the
        store swap + fragment invalidation land strictly between
        flushes -- no batch is ever served half-old, half-new."""
        async with self._flush_lock:
            self.server.repartition(heat)

    # -- flush machinery -----------------------------------------------------

    def _cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _on_timer(self, loop) -> None:
        self._timer = None
        if self._pending:
            loop.create_task(self._flush("timer"))

    async def _flush(self, cause: str) -> None:
        """Dispatch the current batch through ``handle_batch``.

        The lock serializes flushes (FIFO -- asyncio.Lock wakes waiters
        in acquisition order), and the pending queue is swapped out
        *before* dispatch so mid-flush arrivals open a new batch. The
        cause is counted here, after the non-empty batch is taken, so a
        racing timer/full flush that finds an empty queue counts as
        nothing.
        """
        async with self._flush_lock:
            taken = self._pending
            if not taken:
                return
            self._pending = []
            self._cancel_timer()
            # Deadline check at flush (docs/resilience.md): shed every
            # request whose budget expired while it waited -- an expired
            # member never enters the coalesced launch, so live requests
            # pay nothing for a dead neighbor.
            loop = asyncio.get_running_loop()
            now = loop.time()
            batch = []
            for req, fut, expires in taken:
                if expires is not None and now >= expires:
                    self.stats.shed += 1
                    if not fut.done():
                        fut.set_exception(DeadlineExceeded(
                            f"deadline expired "
                            f"{(now - expires) * 1e3:.1f}ms before flush "
                            f"(timeout_ms={req.timeout_ms})"))
                    continue
                batch.append((req, fut))
            if not batch:
                return
            self.stats.flushes += 1
            if cause == "timer":
                self.stats.timer_flushes += 1
            elif cause == "full":
                self.stats.full_flushes += 1
            self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                            len(batch))
            if len(batch) > 1:
                self.stats.coalesced_requests += len(batch)
            reqs = [r for r, _ in batch]
            try:
                if self._executor is not None:
                    frags = await loop.run_in_executor(
                        self._executor, self.server.handle_batch, reqs)
                else:
                    frags = self.server.handle_batch(reqs)
            except Exception as exc:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            for (_, fut), frag in zip(batch, frags, strict=True):
                if not fut.done():
                    fut.set_result(frag)


# ---------------------------------------------------------------------------
# Concurrent drivers (benchmarks, live sim validation, tests)
# ---------------------------------------------------------------------------


async def drive_streams(
    front: AsyncBrTPFServer,
    streams: Sequence[Sequence[Request]],
) -> List[List[Fragment]]:
    """Replay request streams concurrently: one coroutine per stream,
    each awaiting its responses in order (a client pipelines across
    streams, not within one). Returns per-stream fragment lists."""

    async def one(stream: Sequence[Request]) -> List[Fragment]:
        return [await front.handle(r) for r in stream]

    return list(await asyncio.gather(*[one(s) for s in streams]))


def serve_concurrent(
    server: BrTPFServer,
    streams: Sequence[Sequence[Request]],
    batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
    max_batch: int = DEFAULT_MAX_BATCH,
) -> Tuple[List[List[Fragment]], AsyncBrTPFServer]:
    """Synchronous convenience wrapper: build a front end over
    ``server``, replay ``streams`` concurrently, close, and return
    (responses, front) -- ``front.stats`` carries the flush accounting."""
    front = AsyncBrTPFServer(server, batch_window_s=batch_window_s,
                             max_batch=max_batch)

    async def main() -> List[List[Fragment]]:
        try:
            return await drive_streams(front, streams)
        finally:
            await front.aclose()

    return asyncio.run(main()), front
