"""Device: milliseconds per flush of host-to-device copies of launch
inputs and of the kernel wrapper calls: the port's
``copy_in`` spans (``repro_torch.core.trace``) summed over the flushes
that ended in the profiled sub-window, over their count."""
from .flush_ms import phase_per_flush


def read(run):
    return phase_per_flush(run, "copy_in")
