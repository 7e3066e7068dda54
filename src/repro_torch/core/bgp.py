"""Basic graph patterns (BGPs): the query fragment the paper studies.

A BGP is a list of triple patterns sharing a variable namespace. The
paper restricts its study to BGPs (section 1) because they are the
fundamental fragment both client algorithms must handle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .rdf import TermDictionary, TriplePattern, encode_var


@dataclasses.dataclass
class BGP:
    patterns: Tuple[TriplePattern, ...]
    num_vars: int
    var_names: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not self.var_names:
            self.var_names = tuple(f"?v{i}" for i in range(self.num_vars))

    def variables_of(self, i: int) -> Tuple[int, ...]:
        return self.patterns[i].variables()

    def all_variables(self) -> Tuple[int, ...]:
        out: List[int] = []
        for tp in self.patterns:
            for v in tp.variables():
                if v not in out:
                    out.append(v)
        return tuple(out)

    def __len__(self) -> int:
        return len(self.patterns)


def parse_bgp(text: str, dictionary: TermDictionary) -> BGP:
    """Parse a whitespace BGP: one 's p o' triple pattern per line ('.'
    terminators optional); terms starting with '?' are variables."""
    var_ids: Dict[str, int] = {}
    patterns: List[TriplePattern] = []
    for line in text.strip().splitlines():
        line = line.strip().rstrip(".").strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        if len(toks) != 3:
            raise ValueError(f"bad triple pattern: {line!r}")
        comps = []
        for tok in toks:
            if tok.startswith("?"):
                if tok not in var_ids:
                    var_ids[tok] = len(var_ids)
                comps.append(encode_var(var_ids[tok]))
            else:
                comps.append(dictionary.intern(tok))
        patterns.append(TriplePattern(*comps))
    names = tuple(sorted(var_ids, key=var_ids.get))
    return BGP(tuple(patterns), len(var_ids), names)


def bgp_from_arrays(patterns: Sequence[Sequence[int]]) -> BGP:
    """Build a BGP from raw encoded component triples (tests/generators)."""
    tps = tuple(TriplePattern(*map(int, p)) for p in patterns)
    nv = 0
    for tp in tps:
        for v in tp.variables():
            nv = max(nv, v + 1)
    return BGP(tps, nv)


def evaluate_bgp_reference(triples: np.ndarray, bgp: BGP) -> np.ndarray:
    """Brute-force BGP evaluation oracle (for tests): nested-loop join
    over the raw triple array. Returns solution mappings int32 [R, V]."""
    from .rdf import UNBOUND, mapping_from_triple, merge

    solutions = [np.full((bgp.num_vars,), UNBOUND, dtype=np.int32)]
    for tp in bgp.patterns:
        nxt = []
        for mu in solutions:
            inst = tp.instantiate(mu)
            for t in triples:
                m = mapping_from_triple(inst, t, bgp.num_vars)
                if m is not None:
                    nxt.append(merge(mu.copy(), m))
        solutions = nxt
    if not solutions:
        return np.empty((0, bgp.num_vars), dtype=np.int32)
    out = np.stack(solutions).astype(np.int32)
    return np.unique(out, axis=0)
