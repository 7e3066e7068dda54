"""Selectors and store: milliseconds per flush of host work before a
launch's first copy (grouping and instantiation, memo consults,
candidate ranges and sub-ranges, gathers, the sharded planner,
marshalling): the port's
``prep`` spans (``repro_torch.core.trace``) summed over the flushes
that ended in the profiled sub-window, over their count."""
from .flush_ms import phase_per_flush


def read(run):
    return phase_per_flush(run, "prep")
