"""End to end: queries answered in full in the window, per second of the
window. A query stopped at the request budget is not answered, and is
not counted."""
from bench.stats import rate


def read(run):
    return rate(sum(not q["timed_out"] for q in run.queries), run.seconds)
