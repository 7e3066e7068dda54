"""Dictionary-encoded RDF: terms, triple patterns, solution mappings.

The paper's server (HDT backend) operates on dictionary-encoded triples;
we mirror that design: every RDF term (IRI / literal) is interned to an
``int32`` id once, and all engine/device code operates on ids only.

Encoding conventions (used across host numpy code and the device kernels):

* constants (IRIs/literals): ids ``>= 0``
* variables in triple patterns: ``encode_var(v) = -(v + 1)`` (i.e. ``< 0``)
* solution mappings: dense ``int32[num_vars]`` rows, ``UNBOUND = -1`` marks
  an unbound variable.

Keeping variables strictly negative and constants non-negative lets a
single sign test distinguish them inside kernels with no extra storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

UNBOUND: int = -1

# ---------------------------------------------------------------------------
# Term dictionary
# ---------------------------------------------------------------------------


class TermDictionary:
    """Bidirectional string<->id interning (host side only)."""

    def __init__(self) -> None:
        self._by_term: Dict[str, int] = {}
        self._by_id: List[str] = []

    def intern(self, term: str) -> int:
        tid = self._by_term.get(term)
        if tid is None:
            tid = len(self._by_id)
            self._by_term[term] = tid
            self._by_id.append(term)
        return tid

    def lookup(self, term: str) -> Optional[int]:
        return self._by_term.get(term)

    def term(self, tid: int) -> str:
        return self._by_id[tid]

    def __len__(self) -> int:
        return len(self._by_id)


# ---------------------------------------------------------------------------
# Variables and triple patterns
# ---------------------------------------------------------------------------


def encode_var(var_id: int) -> int:
    """Encode variable ``var_id >= 0`` as a negative pattern component."""
    assert var_id >= 0
    return -(var_id + 1)


def decode_var(component: int) -> int:
    """Inverse of :func:`encode_var`; only valid for ``component < 0``."""
    assert component < 0
    return -component - 1


def is_var(component: int) -> bool:
    return component < 0


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    """A triple pattern ``(s, p, o)`` with constants >= 0 and vars < 0."""

    s: int
    p: int
    o: int

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.s, self.p, self.o)

    def variables(self) -> Tuple[int, ...]:
        """Distinct variable ids, in s,p,o position order."""
        out: List[int] = []
        for c in self.as_tuple():
            if is_var(c):
                v = decode_var(c)
                if v not in out:
                    out.append(v)
        return tuple(out)

    def num_bound(self) -> int:
        return sum(0 if is_var(c) else 1 for c in self.as_tuple())

    def instantiate(self, mapping: np.ndarray) -> "TriplePattern":
        """Apply a solution mapping (dense row over all query vars)."""
        comps = []
        for c in self.as_tuple():
            if is_var(c):
                v = decode_var(c)
                b = int(mapping[v]) if v < mapping.shape[0] else UNBOUND
                comps.append(c if b == UNBOUND else b)
            else:
                comps.append(c)
        return TriplePattern(*comps)

    def matches_triple(self, t: Sequence[int]) -> bool:
        """Exact per-definition match check (used by test oracles)."""
        binding: Dict[int, int] = {}
        for c, x in zip(self.as_tuple(), t, strict=True):
            if is_var(c):
                v = decode_var(c)
                if v in binding and binding[v] != x:
                    return False
                binding[v] = x
            elif c != x:
                return False
        return True


# ---------------------------------------------------------------------------
# Solution mappings
# ---------------------------------------------------------------------------


def empty_mappings(num_vars: int) -> np.ndarray:
    return np.empty((0, max(num_vars, 1)), dtype=np.int32)


def compatible(mu: np.ndarray, nu: np.ndarray) -> bool:
    """SPARQL compatibility: agree on every variable bound in both."""
    both = (mu != UNBOUND) & (nu != UNBOUND)
    return bool(np.all(mu[both] == nu[both]))


def merge(mu: np.ndarray, nu: np.ndarray) -> np.ndarray:
    """Merge two compatible mappings (mu takes precedence where bound)."""
    out = mu.copy()
    take = (out == UNBOUND) & (nu != UNBOUND)
    out[take] = nu[take]
    return out


def mapping_from_triple(tp: TriplePattern, triple: Sequence[int],
                        num_vars: int) -> Optional[np.ndarray]:
    """The mapping mu with mu(tp) == triple, or None if no match."""
    mu = np.full((num_vars,), UNBOUND, dtype=np.int32)
    for c, x in zip(tp.as_tuple(), triple, strict=True):
        if is_var(c):
            v = decode_var(c)
            if mu[v] != UNBOUND and mu[v] != x:
                return None
            mu[v] = x
        elif c != x:
            return None
    return mu


def dedup_mappings(omega: np.ndarray) -> np.ndarray:
    """Remove duplicate rows, preserving first-occurrence order."""
    if omega.shape[0] == 0:
        return omega
    _, idx = np.unique(omega, axis=0, return_index=True)
    return omega[np.sort(idx)]


def project_mappings(omega: np.ndarray, var_ids: Iterable[int],
                     num_vars: int) -> np.ndarray:
    """Keep only ``var_ids`` bound; other columns become UNBOUND."""
    out = np.full_like(omega, UNBOUND)
    for v in var_ids:
        if v < num_vars:
            out[:, v] = omega[:, v]
    return out
