"""End to end: the 95th percentile (nearest rank) of the completion time
of every query that ended in the window, from its first request's send
to its result, in milliseconds."""
from bench.stats import nearest_rank


def read(run):
    if not run.queries:
        return None
    return 1e3 * nearest_rank([q["t1"] - q["t0"] for q in run.queries],
                              0.95)
