"""End to end: page requests answered at the edge in the window per
second of the window: the server's capacity under this mix."""
from bench.stats import rate


def read(run):
    return rate(run.requests_between(run.t0, run.t1), run.seconds)
