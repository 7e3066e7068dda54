"""Selectors and store: milliseconds per flush in ``stream_order``, the
host reorder of kept rows into the numpy selector's sequence: the port's
``order`` spans (``repro_torch.core.trace``) summed over the flushes
that ended in the profiled sub-window, over their count."""
from .flush_ms import phase_per_flush


def read(run):
    return phase_per_flush(run, "order")
