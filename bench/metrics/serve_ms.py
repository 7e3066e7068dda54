"""Origin server: milliseconds per flush of the per-request pass after
the prefill (memo reads, paging, cache puts, transfer charges), the
memo puts of fresh selections and the memo trim: the port's
``serve`` spans (``repro_torch.core.trace``) summed over the flushes
that ended in the profiled sub-window, over their count."""
from .flush_ms import phase_per_flush


def read(run):
    return phase_per_flush(run, "serve")
