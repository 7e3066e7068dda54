"""Device: the share of the profiled sub-window in which no operation
ran on the card, in percent (one minus the union of its device records
over the sub-window's wall time)."""


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
