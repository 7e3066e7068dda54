"""The comparison that decides ``correct``.

A run is correct when, on a sample drawn from the seed once the window
has closed, every fragment the clients received through the edge equals
the plain reference's page (data triples in order, ``cnt`` and
``has_next``), every sampled query that ended complete has the
reference's solutions, every request sent was answered without an
error (a minute past the close at most), and no query raised. Each of
these numbers is an exact comparison: its limit is 0.

The served side is handed over as plain values (pattern tuples, mapping
arrays, page numbers, triple arrays), so that nothing here reads the
system under test beyond its answers.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import reference

# name -> limit; every number is a count of disagreements or failures.
LIMITS = {"fragment_mismatches": 0, "solution_mismatches": 0,
          "request_errors": 0, "unanswered_requests": 0, "query_errors": 0}

Served = Tuple[tuple, Optional[np.ndarray], int, bool,   # the request
               np.ndarray, int, bool]                    # the answer


class Answers:
    """Reference pages, each fragment's sequence computed once."""

    def __init__(self, store: reference.ReferenceStore, page_size: int,
                 fragment: Callable = reference.fragment) -> None:
        self.store, self.page_size, self.fragment = store, page_size, fragment
        self._memo: Dict[tuple, Tuple[np.ndarray, int]] = {}

    def page(self, pattern, omega, page_no, count_only):
        key = (tuple(pattern), None if omega is None
               else np.asarray(omega, np.int32).tobytes(),
               None if omega is None else np.asarray(omega).shape)
        if key not in self._memo:
            self._memo[key] = self.fragment(self.store, pattern, omega)
        data, cnt = self._memo[key]
        if count_only:
            return np.empty((0, 3), np.int32), cnt, False
        return reference.page(data, cnt, page_no, self.page_size)


def same_page(served: Served, want) -> bool:
    data, cnt, has_next = served[4:]
    w_data, w_cnt, w_next = want
    data = np.asarray(data, dtype=np.int32).reshape(-1, 3)
    return (data.shape == w_data.shape and bool((data == w_data).all())
            and int(cnt) == int(w_cnt) and bool(has_next) == bool(w_next))


def fragment_mismatches(answers: Answers, served: Sequence[Served]) -> int:
    return sum(not same_page(s, answers.page(*s[:4])) for s in served)


def solution_mismatches(store: reference.ReferenceStore,
                        queries: Sequence[Tuple[np.ndarray, np.ndarray]]
                        ) -> int:
    """``queries``: (patterns int [n, 3], served solutions int [R, V]).
    The solutions of a BGP over a set of triples are distinct, so the
    served rows are sorted but not made distinct: a row served twice is
    a mismatch."""
    bad = 0
    for patterns, got in queries:
        want = reference.solutions(store, patterns)
        got = np.asarray(got, dtype=np.int32)
        if got.shape[0] == 0 and want.shape[0] == 0:
            continue
        if got.ndim == 2 and got.shape[0]:
            got = got[np.lexsort(got.T[::-1])]
        if got.shape != want.shape or not (got == want).all():
            bad += 1
    return bad


def sample(n: int, k: int, rng: np.random.Generator,
           first: Sequence[int] = ()) -> List[int]:
    """``first``, then up to ``k`` indices in all, drawn without
    replacement from range(n)."""
    chosen = list(dict.fromkeys(first))[:k]
    rest = np.setdiff1d(np.arange(n), chosen)
    more = rng.choice(rest, size=min(k - len(chosen), rest.size),
                      replace=False) if k > len(chosen) else []
    return chosen + [int(i) for i in more]


def verdict(values: Dict[str, int]) -> Tuple[bool, Dict[str, dict]]:
    checks = {name: {"value": int(values[name]), "limit": limit}
              for name, limit in LIMITS.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
