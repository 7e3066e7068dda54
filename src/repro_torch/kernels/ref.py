"""Plain PyTorch oracles for the kernels (the port of ``repro/kernels/ref.py``).

These are the semantic ground truth: each is an exact integer function,
held against the JAX package's ``ref.py`` on identical inputs
(``tests/test_torch_kernels.py``), and each hand-written CUDA kernel is
held against its plain version on the card (``chip_smoke.py``).

Conventions (shared with the kernels):
* triples are structure-of-arrays int32 ``s[T], p[T], o[T]``;
* *instantiated* pattern components use ``component < 0`` as wildcard;
* validity masks flag padding rows (fixed shapes).
"""
from __future__ import annotations

import torch


def _first_index(comp: torch.Tensor, m: int) -> torch.Tensor:
    """Smallest index along the last axis where ``comp`` holds, else m."""
    cols = torch.arange(m, dtype=torch.int32, device=comp.device)
    big = torch.full((), m, dtype=torch.int32, device=comp.device)
    return torch.where(comp, cols, big).amin(dim=-1)


def bindjoin_ref(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o, pat_valid):
    """Reference bindings-restricted filter.

    For candidate triples t (SoA, [T]) and M instantiated patterns
    ([M], wildcard < 0, ``pat_valid`` zero for padding), compute:

      keep[T]  -- does t match at least one valid instantiated pattern?
      idx[T]   -- smallest matching pattern index, or M if none.
    """
    m = pat_s.shape[0]
    comp = (
        ((pat_s[None, :] < 0) | (cand_s[:, None] == pat_s[None, :]))
        & ((pat_p[None, :] < 0) | (cand_p[:, None] == pat_p[None, :]))
        & ((pat_o[None, :] < 0) | (cand_o[:, None] == pat_o[None, :]))
        & (pat_valid[None, :] != 0)
    )  # [T, M]
    return comp.any(dim=1), _first_index(comp, m)


def bindjoin_grouped_ref(cand_s, cand_p, cand_o, pat_s, pat_p, pat_o,
                         pat_valid):
    """Reference grouped bind-join filter.

    Pattern components are ``[G, M]`` (G request groups sharing one
    candidate pass). Returns per-group results:

      keep[T, G]    -- row matches >= 1 valid pattern of group g
      idx[T, G]     -- smallest matching within-group pattern index
                       (= M when none)
      nmatch[T, G]  -- number of group g's patterns the row matches
                       (the Definition-2 ``cnt`` contribution of the row)
    """
    m = pat_s.shape[1]
    cs = cand_s[:, None, None]
    cp = cand_p[:, None, None]
    co = cand_o[:, None, None]
    ms, mp, mo = pat_s[None], pat_p[None], pat_o[None]
    comp = (
        ((ms < 0) | (cs == ms))
        & ((mp < 0) | (cp == mp))
        & ((mo < 0) | (co == mo))
        & (pat_valid[None] != 0)
    )  # [T, G, M]
    nmatch = comp.sum(dim=-1, dtype=torch.int32)
    return comp.any(dim=-1), _first_index(comp, m), nmatch


def bindjoin_fused_ref(cand_s, cand_p, cand_o, seg_of_row, pat_s, pat_p,
                       pat_o, pat_valid):
    """Reference cross-pattern fused bind-join filter.

    Pattern components are ``[S, G, M]`` (S segments, each with G request
    groups); ``seg_of_row`` is int32 ``[T]`` mapping each candidate row
    to its segment (-1 = dead padding row, matches nothing). Returns
    keep/idx/nmatch ``[T, G]`` where column g holds the row's result
    against *its own segment's* group-g pattern set (idx = M if none).
    """
    m = pat_s.shape[2]
    seg = seg_of_row.clamp(min=0).long()
    ms, mp, mo, mv = pat_s[seg], pat_p[seg], pat_o[seg], pat_valid[seg]
    cs = cand_s[:, None, None]
    cp = cand_p[:, None, None]
    co = cand_o[:, None, None]
    comp = (
        ((ms < 0) | (cs == ms))
        & ((mp < 0) | (cp == mp))
        & ((mo < 0) | (co == mo))
        & (mv != 0)
        & (seg_of_row >= 0)[:, None, None]
    )  # [T, G, M]
    nmatch = comp.sum(dim=-1, dtype=torch.int32)
    return comp.any(dim=-1), _first_index(comp, m), nmatch


def tpf_match_ref(cand_s, cand_p, cand_o, pattern_vec):
    """Reference triple-pattern matcher.

    ``pattern_vec`` is int32[8]: [s, p, o, eq_sp, eq_so, eq_po, 0, 0]
    where components < 0 are wildcards and the eq_* flags request
    repeated-variable equality between positions.
    """
    s, p, o = pattern_vec[0], pattern_vec[1], pattern_vec[2]
    eq_sp, eq_so, eq_po = pattern_vec[3], pattern_vec[4], pattern_vec[5]
    mask = (
        ((s < 0) | (cand_s == s))
        & ((p < 0) | (cand_p == p))
        & ((o < 0) | (cand_o == o))
    )
    mask &= (eq_sp == 0) | (cand_s == cand_p)
    mask &= (eq_so == 0) | (cand_s == cand_o)
    mask &= (eq_po == 0) | (cand_p == cand_o)
    return mask


def compat_join_ref(mu, omega, unbound=-1):
    """Reference mapping-compatibility matrix.

    ``mu``: int32[T, V] mappings extracted from fragment triples;
    ``omega``: int32[M, V] attached mappings. Returns bool[T, M] where
    entry (t, m) is SPARQL-compatibility of mu[t] and omega[m].
    """
    a = mu[:, None, :]
    b = omega[None, :, :]
    both = (a != unbound) & (b != unbound)
    return (~both | (a == b)).all(dim=-1)
