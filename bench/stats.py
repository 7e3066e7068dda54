"""Statistics of one run and across runs."""
from __future__ import annotations

import statistics
from typing import Sequence


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile by nearest rank on the sorted values (the rank
    rule of the port's ``core.metrics.latency_summary``)."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    n = len(ordered)
    return ordered[min(n - 1, max(0, int(q * n + 0.5) - 1))]


def rate(count: int, seconds: float) -> float:
    """Events per second over a window of ``seconds`` (never the sum of
    the events' own durations, which overlap under concurrency)."""
    if seconds <= 0:
        raise ValueError("window must be positive")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile, as Python's
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
