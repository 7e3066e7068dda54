"""Kernels: milliseconds per flush from a kernel wrapper's return to the
kept rows on the host (compaction, the device-to-host copy, and the
host's wait for the card): the port's
``collect`` spans (``repro_torch.core.trace``) summed over the flushes
that ended in the profiled sub-window, over their count."""
from .flush_ms import phase_per_flush


def read(run):
    return phase_per_flush(run, "collect")
