"""Spans of the serving path, recorded while a ``torch.profiler`` session
is on (re-exported by ``core/metrics.py``, the port's observability
module).

A span is a named interval on ``time.perf_counter_ns()``: its own id,
the id of the span that caused it (0: none), its request id (a flush:
the ids of the requests it serves), and for a flush its ``cause``
(``timer``, ``full``, ``inline``, ``close``) and, for a timer flush, the
time its timer fell due. The serving path records:

* ``request``: the ASGI app's ``/fragment`` call (body, decode, backend,
  encode, send); ``front``: ``AsyncBrTPFServer.handle`` inside it;
  ``wait``: enqueue to the start of the flush that serves the request.
  The three share the request's id, drawn by the app (or by the front
  end for in-process callers) from one process-wide counter.
* ``flush``: ``BrTPFServer.handle_batch`` as the front end calls it,
  and, inside it, its host phases as children: ``prep`` (grouping,
  instantiation, memo consults, ranges, planning, marshalling),
  ``copy_in`` (host-to-device copies of launch inputs and the kernel
  wrapper call), ``collect`` (compaction and the copy back),
  ``order`` (``stream_order``) and ``serve`` (the per-request pass,
  memo puts and trim). A phase runs from its mark (:func:`phase`) to
  the next mark on the thread that runs the flush, so a flush's phases
  never overlap and no phase is counted twice when one selector path
  calls another; a caller marks its own phase again when a selector
  returns, so the selector's last phase does not take the caller's work.

Nothing is recorded without a profiler: each span site tests
``torch.autograd.profiler._is_profiler_enabled`` (the module flag every
``torch.profiler`` session sets, seen from every thread) and does
nothing else. With a profiler on, each span also opens a
``record_function`` range of its name, so a ``[CPU, CUDA]`` profile
shows the phases on the device trace's clock.

Spans go to a bounded ring (:data:`TRACE`); a full ring drops its oldest
span and counts the drop. docs/torch_tracing.md is the operator's guide.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from contextvars import ContextVar
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _profiler

# A record_function range opened and closed in C++ (about a tenth of the
# Python context manager's cost, and its clock reading sits closer to the
# span's own); the same user range in the profile.
_Range = torch._C._profiler._RecordFunctionFast

# 65,536 spans: a 4-s profile of the busiest served cell records about a
# fifth of that (PERF.md, section 3); a full ring holds about 17 MiB.
RING_CAPACITY = 1 << 16

PHASES = ("prep", "copy_in", "collect", "order", "serve")


class Span(NamedTuple):
    name: str
    id: int
    parent: int                       # 0: none
    req: Union[int, Tuple[int, ...]]  # request id; a flush: its members'
    t0: int                           # time.perf_counter_ns()
    t1: int
    cause: Optional[str] = None       # a flush: timer, full, inline, close
    due: Optional[int] = None         # a timer flush: when its timer fell
    #                                   due, on the same clock as t0


class SpanRing:
    """Bounded in-memory store of finished spans."""

    def __init__(self, capacity: int = RING_CAPACITY) -> None:
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=int(capacity))
        self._dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def spans(self, lo_s: float, hi_s: float) -> List[Span]:
        """The spans that ended in ``[lo_s, hi_s]``, ``time.perf_counter``
        seconds."""
        lo, hi = lo_s * 1e9, hi_s * 1e9
        with self._lock:
            held = list(self._spans)
        return [s for s in held if lo <= s.t1 <= hi]

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0


TRACE = SpanRing()

# The request a task is serving: (request id, its request span's id).
REQUEST: ContextVar[Optional[Tuple[int, int]]] = ContextVar(
    "repro_torch_request", default=None)

_ids = itertools.count(1)
_local = threading.local()


def enabled() -> bool:
    """The one test of a span site: a ``torch.profiler`` session is on."""
    return _profiler._is_profiler_enabled


class Open:
    """A span in progress. Its clock readings lie inside its
    ``record_function`` range: ``t0`` is read once the range is open,
    ``t1`` before it closes."""

    __slots__ = ("name", "id", "parent", "req", "t0", "_range")

    def __init__(self, name: str, parent: int, req) -> None:
        self.name, self.parent, self.req = name, parent, req
        self.id = next(_ids)
        self._range = _Range(name)
        self._range.__enter__()
        self.t0 = time.perf_counter_ns()

    def close(self, t1: Optional[int] = None, cause: Optional[str] = None,
              due: Optional[int] = None) -> None:
        t1 = time.perf_counter_ns() if t1 is None else t1
        self._range.__exit__(None, None, None)
        TRACE.add(Span(self.name, self.id, self.parent, self.req, self.t0,
                       t1, cause, due))


def request_span() -> Tuple[Open, object]:
    """Open a ``request`` span under a new request id, and make it the
    task's request; close with :func:`end_request`."""
    span = Open("request", 0, next(_ids))
    return span, REQUEST.set((span.req, span.id))


def end_request(span: Open, token, t1: int) -> None:
    REQUEST.reset(token)
    span.close(t1)


def front_span() -> Open:
    """Open a ``front`` span under the task's request, or under a new
    request id where no request span is open (in-process callers)."""
    cur = REQUEST.get()
    if cur is None:
        return Open("front", 0, next(_ids))
    return Open("front", cur[1], cur[0])


class _Cursor:
    """The flush a thread is running and its open phase."""

    __slots__ = ("flush", "phase")

    def __init__(self, flush: int) -> None:
        self.flush = flush
        self.phase: Optional[Open] = None


class Flush:
    """A ``flush`` span: opened where the front end dispatches a batch,
    bound to the thread that runs ``handle_batch`` (:meth:`bind`), closed
    when the batch is served."""

    def __init__(self, waits: List[Open], cause: str,
                 due_loop_s: Optional[float]) -> None:
        for wait in waits:
            wait.close()
        self.cause = cause
        self.due = None
        if due_loop_s is not None:
            # the loop's clock (time.monotonic) moved onto perf_counter
            self.due = round(due_loop_s * 1e9) + (time.perf_counter_ns()
                                                  - time.monotonic_ns())
        self.span = Open("flush", 0, tuple(w.req for w in waits))

    def bind(self, fn: Callable) -> Callable:
        """``fn`` run with this flush as the parent of the phases that the
        running thread marks (the executor does not carry the caller's
        context)."""
        flush_id = self.span.id

        def run(*args):
            prev = getattr(_local, "cursor", None)
            cur = _local.cursor = _Cursor(flush_id)
            try:
                return fn(*args)
            finally:
                if cur.phase is not None:
                    cur.phase.close()
                _local.cursor = prev

        return run

    def close(self) -> None:
        self.span.close(cause=self.cause, due=self.due)


def phase(name: str) -> None:
    """Enter host phase ``name`` of the flush the running thread serves:
    the open phase ends and ``name`` starts (the time between, closing one
    range and opening the next, is the flush's own). A no-op outside a
    flush, or when ``name`` is already open."""
    if not _profiler._is_profiler_enabled:
        return
    cur = getattr(_local, "cursor", None)
    if cur is None:
        return
    prev = cur.phase
    if prev is not None and prev.name == name:
        return
    if prev is not None:
        prev.close()
    cur.phase = Open(name, cur.flush, 0)
