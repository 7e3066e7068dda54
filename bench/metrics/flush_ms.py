"""Origin server: milliseconds per flush, mean over the port's ``flush``
spans (``BrTPFServer.handle_batch`` as the batching front end calls it,
``repro_torch.core.trace``) that ended in the profiled sub-window.

``window`` and ``phase_per_flush`` serve every reader of the port's own
spans."""


def window(run):
    """The port's spans that ended in ``[run.profile_t0, run.profile_t1]``;
    None where there are none, where its recorder dropped any, or where
    the port records no span."""
    try:
        from repro_torch.core.metrics import TRACE
    except ImportError:
        return None
    spans = TRACE.spans(run.profile_t0, run.profile_t1)
    if not spans or TRACE.dropped():
        return None
    return spans


def phase_per_flush(run, name):
    """Milliseconds of host phase ``name`` per flush: its spans' summed
    time in the flushes that ended in the window, over their count."""
    spans = window(run)
    if spans is None:
        return None
    flushes = {s.id for s in spans if s.name == "flush"}
    if not flushes:
        return None
    total = sum(s.t1 - s.t0 for s in spans
                if s.name == name and s.parent in flushes)
    return total / 1e6 / len(flushes)


def read(run):
    spans = window(run)
    flushes = [s for s in spans or () if s.name == "flush"]
    if not flushes:
        return None
    return sum(s.t1 - s.t0 for s in flushes) / 1e6 / len(flushes)
