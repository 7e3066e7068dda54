"""Serving edge: milliseconds per page request spent in the ASGI app
outside the batching front end, on the server's side only: the port's
``request`` span (``BrTPFApp`` on ``/fragment``: body, decode, backend,
encode, send) minus its ``front`` child (``AsyncBrTPFServer.handle``),
mean over the requests that ended in the profiled sub-window."""
from .flush_ms import window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    requests = [s for s in spans if s.name == "request"]
    if not requests:
        return None
    front = {s.parent: s.t1 - s.t0 for s in spans if s.name == "front"}
    own = sum(r.t1 - r.t0 - front.get(r.id, 0) for r in requests)
    return own / 1e6 / len(requests)
