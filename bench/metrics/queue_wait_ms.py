"""Batching front end: milliseconds from a request's enqueue to the start
of the flush that serves it, mean over the port's ``wait`` spans that
ended in the profiled sub-window."""
from .flush_ms import window


def read(run):
    waits = [s for s in window(run) or () if s.name == "wait"]
    if not waits:
        return None
    return sum(s.t1 - s.t0 for s in waits) / 1e6 / len(waits)
