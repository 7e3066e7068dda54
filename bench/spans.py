"""Spans and launch records of a traced run, taken from the benchmark's
side of each layer boundary.

``Instruments`` wraps the calls into each layer of one served stack for
the length of a traced run and restores them afterwards:

* ``edge``: ``AsgiTransport.handle``, one span per page request (the
  whole HTTP edge: wire codec, ASGI app, and the wait for the server);
* ``front``: ``AsyncBrTPFServer.handle`` inside it (batching window,
  or the resident-page fast path, and the flush that serves it);
* ``handle_batch``: ``BrTPFServer.handle_batch``, one span per flush,
  with the batching wait of each request it serves (enqueue to flush);
* ``wire``: the brtpf/v1 codec calls of the transport and the app;
* ``client``: the client's joins of received triples with its mappings;
* one launch record per call of each kernel wrapper named by a file of
  ``bench/roofline/``: its span, whether it launched, and the facts the
  file's ``work`` needs to count the launch's operations and bytes.

Spans are kept in memory, on ``time.perf_counter`` seconds.
"""
from __future__ import annotations

import functools
import importlib
import time
from typing import Dict, List, Tuple

# Synchronous spans, innermost first (a kernel call runs inside a flush).
SYNC_SPANS = ("kernel", "handle_batch", "wire", "client")


class Instruments:
    def __init__(self, transport, front, server, rooflines) -> None:
        self.spans: Dict[str, List[Tuple[float, float]]] = {
            name: [] for name in ("edge", "front", "handle_batch", "wire",
                                  "client", "kernel")}
        self.waits: List[Tuple[float, float]] = []   # (flush start, wait)
        self.launches: List[dict] = []
        self._enqueued: Dict[int, float] = {}
        self._restore: List[Tuple[object, str, object, bool]] = []
        self._wrap_async(transport, "handle", "edge")
        self._wrap_front(front)
        self._wrap_batch(server)
        transport_mod = importlib.import_module(
            "repro_torch.serving.transport")
        http_mod = importlib.import_module("repro_torch.serving.http")
        for mod in (transport_mod, http_mod):
            for fn in ("dumps", "loads", "request_to_wire",
                       "request_from_wire", "fragment_to_wire",
                       "fragment_from_wire"):
                if hasattr(mod, fn):
                    self._wrap_sync(mod, fn, "wire")
        client_mod = importlib.import_module("repro_torch.core.client")
        for fn in ("_bind_join", "_mappings_from_matches"):
            self._wrap_sync(client_mod, fn, "client")
        ops = importlib.import_module("repro_torch.kernels.ops")
        for name, mod in rooflines.items():
            self._wrap_kernel(ops, name, mod)

    # -- wrapping ------------------------------------------------------------

    def _set(self, owner, attr, new) -> None:
        own = attr in vars(owner) if hasattr(owner, "__dict__") else True
        self._restore.append((owner, attr, getattr(owner, attr), own))
        setattr(owner, attr, new)

    def restore(self) -> None:
        for owner, attr, old, own in reversed(self._restore):
            if own:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._restore = []

    def _wrap_async(self, owner, attr, span) -> None:
        inner = getattr(owner, attr)
        spans = self.spans[span]

        @functools.wraps(inner)
        async def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return await inner(*args, **kwargs)
            finally:
                spans.append((t0, time.perf_counter()))

        self._set(owner, attr, wrapped)

    def _wrap_sync(self, owner, attr, span) -> None:
        inner = getattr(owner, attr)
        spans = self.spans[span]

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                spans.append((t0, time.perf_counter()))

        self._set(owner, attr, wrapped)

    def _wrap_front(self, front) -> None:
        inner = front.handle
        spans, enqueued = self.spans["front"], self._enqueued

        async def wrapped(req):
            t0 = time.perf_counter()
            enqueued[id(req)] = t0
            try:
                return await inner(req)
            finally:
                enqueued.pop(id(req), None)
                spans.append((t0, time.perf_counter()))

        self._set(front, "handle", wrapped)

    def _wrap_batch(self, server) -> None:
        inner = server.handle_batch
        spans, enqueued = self.spans["handle_batch"], self._enqueued

        def wrapped(reqs):
            t0 = time.perf_counter()
            self.waits.extend((t0, t0 - enqueued[id(r)]) for r in reqs
                              if id(r) in enqueued)
            try:
                return inner(reqs)
            finally:
                spans.append((t0, time.perf_counter()))

        self._set(server, "handle_batch", wrapped)

    def _wrap_kernel(self, ops, name, mod) -> None:
        inner = getattr(ops, mod.WRAPPER)
        spans, launches = self.spans["kernel"], self.launches

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            before = inner.launches
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                spans.append((t0, t1))
                if inner.launches > before:
                    launches.append(dict(kernel=name, t0=t0, t1=t1,
                                         facts=mod.facts(*args, **kwargs)))

        self._set(ops, mod.WRAPPER, wrapped)


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total
