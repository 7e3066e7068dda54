"""Origin server: the share of flush time in no host phase, in percent:
the port's ``flush`` spans' time not covered by their phase children
(``prep``, ``copy_in``, ``collect``, ``order``, ``serve``), over the
flushes' time, for the flushes that ended in the profiled sub-window."""
from .flush_ms import window


def read(run):
    spans = window(run)
    if spans is None:
        return None
    flushes = {s.id: s.t1 - s.t0 for s in spans if s.name == "flush"}
    total = sum(flushes.values())
    if total <= 0:
        return None
    covered = sum(s.t1 - s.t0 for s in spans if s.parent in flushes)
    return 100.0 * (total - covered) / total
