"""Batching front end: the event loop's lateness, milliseconds from the
time a flush's timer fell due to the start of that flush, mean over the
port's timer-caused ``flush`` spans that ended in the profiled
sub-window."""
from .flush_ms import window


def read(run):
    timed = [s for s in window(run) or ()
             if s.name == "flush" and s.cause == "timer"]
    if not timed:
        return None
    return sum(s.t0 - s.due for s in timed) / 1e6 / len(timed)
