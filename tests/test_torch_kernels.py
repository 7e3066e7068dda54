"""Kernel ops of the PyTorch port against the JAX package's, exactly.

The same seeded numpy inputs go through ``repro.kernels`` (Pallas in
interpret mode on the CPU) and ``repro_torch.kernels`` (the kernels'
plain PyTorch versions on the CPU). All outputs are integers, so the
tolerance is exact equality, padding rows included.

``tests/test_torch_cuda.py`` holds the hand-written CUDA kernels'
checks against these plain versions on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.tpf_match import tpf_match_cuda

# the package re-exports the bindjoin op under the module's name
tbindjoin = importlib.import_module("repro_torch.kernels.bindjoin")

pytestmark = pytest.mark.tier1


def rand_triples(rng, t, terms=6):
    return rng.integers(0, terms, size=(t, 3)).astype(np.int32)


def rand_patterns(rng, shape, terms=6, wild_frac=0.4):
    pats = rng.integers(0, terms, size=(*shape, 3)).astype(np.int32)
    pats[rng.random((*shape, 3)) < wild_frac] = -1
    return pats


def same(jax_out, torch_out):
    want = np.asarray(jax_out)
    got = torch_out.cpu().numpy()
    assert got.shape == want.shape
    if want.dtype == bool:
        assert got.dtype == bool
    else:
        assert got.dtype == np.int32, got.dtype
    np.testing.assert_array_equal(got, want)


def tt(x):
    return torch.as_tensor(np.asarray(x))


class TestTpfMatch:
    @pytest.mark.parametrize("t", [0, 1, 1000, 33000])
    @pytest.mark.parametrize("vec", [
        (-1, -1, -1, 0, 0, 0),        # all wild
        (2, -1, -1, 0, 0, 0),
        (-1, 3, 1, 0, 0, 0),
        (-1, 2, -1, 0, 1, 0),         # (?x, 2, ?x)
        (-1, -1, -1, 1, 1, 1),        # (?x, ?x, ?x)
        (-1, -1, 4, 1, 0, 0),         # (?x, ?x, 4)
        (-1, -1, -1, 0, 0, 1),        # (?s, ?x, ?x)
    ])
    def test_matches_reference(self, t, vec):
        rng = np.random.default_rng(t + 7 * sum(v + 1 for v in vec))
        cand = rand_triples(rng, t, terms=4)
        pv = np.array([*vec, 0, 0], np.int32)
        want = jops.tpf_match(jnp.asarray(cand), jnp.asarray(pv))
        got = tops.tpf_match(tt(cand), tt(pv))
        same(want, got)

    def test_padded_rows_match_reference_kernel(self):
        """The wrapper on padded inputs, padding rows compared too."""
        rng = np.random.default_rng(11)
        cand = rand_triples(rng, 32768, terms=3)
        cand[-100:] = [-1, -2, -3]            # the op's padding values
        for vec in [(-1, -1, -1, 0, 0, 0), (-1, -1, -1, 1, 0, 0),
                    (1, -1, -1, 0, 0, 1)]:
            pv = np.array([*vec, 0, 0], np.int32)
            want = jops.tpf_match_pallas(
                *(jnp.asarray(cand[:, i]) for i in range(3)),
                jnp.asarray(pv), interpret=True)
            got = tpf_match_cuda(tt(cand), tt(pv))
            assert got.dtype == torch.uint8
            same(want, got.to(torch.int32))


GROUPED_CASES = [
    # (t, g, m)
    (1, 1, 1), (700, 3, 30), (1024, 1, 128), (2500, 2, 200),
    (4096, 4, 30), (100, 4, 200),
]


class TestBindjoinGrouped:
    @pytest.mark.parametrize("t,g,m", GROUPED_CASES)
    def test_matches_reference(self, t, g, m):
        rng = np.random.default_rng(t * 7 + g * 3 + m)
        cand = rand_triples(rng, t)
        pats = rand_patterns(rng, (g, m))
        valid = (rng.random((g, m)) < 0.85).astype(np.int32)
        want = jops.bindjoin_grouped(jnp.asarray(cand), jnp.asarray(pats),
                                     jnp.asarray(valid))
        got = tops.bindjoin_grouped(tt(cand), tt(pats), tt(valid))
        for w, o in zip(want, got, strict=True):
            same(w, o)

    @pytest.mark.parametrize("case", ["all_wild", "all_invalid"])
    def test_degenerate_slots(self, case):
        rng = np.random.default_rng(5)
        cand = rand_triples(rng, 900)
        pats = rand_patterns(rng, (3, 30))
        valid = np.ones((3, 30), np.int32)
        if case == "all_wild":
            pats[:] = -1
        else:
            valid[:] = 0
        want = jops.bindjoin_grouped(jnp.asarray(cand), jnp.asarray(pats),
                                     jnp.asarray(valid))
        got = tops.bindjoin_grouped(tt(cand), tt(pats), tt(valid))
        for w, o in zip(want, got, strict=True):
            same(w, o)

    def test_padded_rows_match_reference_kernel(self):
        """The wrapper with its prologue off (one page over [0, T), a
        wildcard base vector, dense outputs) against the padded Pallas
        kernel: zero padding rows match wildcard slots, and idx's
        no-match value is Mp, not m."""
        rng = np.random.default_rng(12)
        g, mp = 2, 256
        cand = rand_triples(rng, 2048)
        cand[1500:] = 0                              # padding rows
        flat = [rand_patterns(rng, (g * mp,))[:, i].copy()
                for i in range(3)]
        pv = (rng.random(g * mp) < 0.1).astype(np.int32)
        want = jops.bindjoin_grouped_pallas(
            *(jnp.asarray(cand[:, i]) for i in range(3)),
            *(jnp.asarray(x) for x in flat), jnp.asarray(pv), groups=g,
            interpret=True)
        slots = np.stack([*flat, pv], axis=1).reshape(g, mp, 4)
        mask, idx, cnt, nmatch = tbindjoin.bindjoin_grouped_cuda(
            tt(cand)[None], None, tt(slots),
            tt(tops.pattern_vec_from((-1, -1, -1))),
            spans=torch.tensor([[[0, 2048]]]), width=2048, live=mp,
            dense=True)
        got = [x[0, 0].T for x in (mask.to(torch.int32), idx, nmatch)]
        assert int(got[1].max()) == mp              # some row matched none
        for w, o in zip(want, got, strict=True):
            same(w, o)
        assert int(cnt.sum()) == int(np.asarray(want[2]).sum())


def jax_grouped_windows(triples, valid, pats, pat_valid, base_vec, *,
                        spans=None, rows=None, width):
    """The JAX package's grouped steps per (page, shard): the window
    slice (or the compact step's row gather), ``bindjoin_grouped`` +
    ``tpf_match`` + the valid and span masks, and the ``cnt`` sum of
    ``repro/core/federation.py`` (lowerable_windowed_grouped). Every
    slice goes through one op call. Returns the kept cells as
    {(p, s, g, key): first}, key the row's position in span mode and its
    index in the list in row mode, and cnt [P, S, G]."""
    s_n, n = valid.shape
    p_n = (spans if rows is None else rows).shape[0]
    cands, oks, keys = [], [], []
    for p in range(p_n):
        for s in range(s_n):
            if rows is None:
                lo, hi = (int(x) for x in spans[p, s])
                start = min(max(lo, 0), max(n - width, 0))
                pos = start + np.arange(width)
                ok = (pos >= lo) & (pos < min(lo + width, hi))
                keys.append(pos)
            else:
                pos = np.maximum(rows[p, s], 0)
                ok = rows[p, s] >= 0
                keys.append(np.arange(width))
            cands.append(triples[s, pos])
            oks.append(ok & valid[s, pos])
    flat = np.concatenate(cands)
    keep, idx, nmatch = (np.asarray(x) for x in jops.bindjoin_grouped(
        jnp.asarray(flat), jnp.asarray(pats), jnp.asarray(pat_valid)))
    base = np.asarray(jops.tpf_match(jnp.asarray(flat),
                                     jnp.asarray(base_vec)))
    mask = keep & base[:, None] & np.concatenate(oks)[:, None]   # (R, G)
    g = mask.shape[1]
    cnt = np.where(mask, nmatch, 0).astype(np.int64).reshape(
        p_n, s_n, width, g).sum(axis=2)
    key = np.concatenate(keys)
    cells = {}
    for row, gi in zip(*np.nonzero(mask), strict=True):
        ps, _ = divmod(int(row), width)
        cells[(ps // s_n, ps % s_n, int(gi), int(key[row]))] = \
            int(idx[row, gi])
    return cells, cnt


def torch_grouped_cells(mask, first, spans=None, rows=None):
    """The port's kept cells in the same {(p, s, g, key): first} form."""
    cells = {}
    for p, s, gi, r in torch.nonzero(mask).tolist():
        key = r if rows is not None else int(spans[p, s, 0]) + r
        cells[(p, s, gi, key)] = int(first[p, s, gi, r])
    return cells


# (s, p, o, eq_sp, eq_so, eq_po): wildcard, a bound component, and the
# three repeated-variable flags
BASE_VECS = [(-1, -1, -1, 0, 0, 0), (-1, 1, -1, 0, 0, 0),
             (-1, -1, -1, 1, 0, 0), (-1, -1, -1, 0, 1, 1)]


class TestBindjoinWindows:
    """The grouped kernel's windowed form (its plain version on the CPU)
    against the JAX package's grouped steps, exactly: P = 3 pages of
    S = 4 shards, W = 16, three groups (one slot table with a hole, one
    all padding), spans that straddle a shard's end and pages past it,
    routed spans with idle (0, 0) shards, and compact row lists."""

    S, N, W, P = 4, 40, 16, 3

    def inputs(self, seed):
        rng = np.random.default_rng(seed)
        triples = rng.integers(0, 4, size=(self.S, self.N, 3)).astype(
            np.int32)
        valid = rng.random((self.S, self.N)) < 0.9
        pats = rand_patterns(rng, (3, 5), terms=4)
        pat_valid = np.ones((3, 5), np.int32)
        pat_valid[0, [1, 3, 4]] = 0      # a hole below the last live slot
        pat_valid[1, 4] = 0
        pat_valid[2] = 0                 # a padding group: no live slot
        return triples, valid, pats, pat_valid

    def spans(self, mode, rng):
        if mode == "routed":
            lo = rng.integers(0, self.N - self.W, size=(self.P, self.S))
            hi = lo + rng.integers(0, self.W + 1, size=(self.P, self.S))
            idle = rng.random((self.P, self.S)) < 0.3
            lo[idle] = hi[idle] = 0
            return np.stack([lo, hi], axis=-1).astype(np.int64)
        # the windowed step: range [start, end) per shard, pages 0, 2, 3
        # of W rows; the last pages straddle the shard's end or lie past
        # the range
        start = np.array([0, 5, 17, 30])
        end = np.array([40, 38, 40, 40])
        pages = np.array([0, 2, 3])
        lo = start[None, :] + pages[:, None] * self.W
        hi = np.minimum(lo + self.W, end[None, :])
        return np.stack([lo, hi], axis=-1).astype(np.int64)

    @pytest.mark.parametrize("base", BASE_VECS)
    @pytest.mark.parametrize("mode", ["windowed", "routed", "rows"])
    def test_matches_jax_grouped_steps(self, mode, base):
        rng = np.random.default_rng(BASE_VECS.index(base) + 10 * len(mode))
        triples, valid, pats, pat_valid = self.inputs(len(mode))
        base_vec = np.array([*base, 0, 0], np.int32)
        spans = rows = None
        if mode == "rows":
            rows = np.full((self.P, self.S, self.W), -1, np.int32)
            for p in range(self.P):
                for s in range(self.S):
                    k = int(rng.integers(0, self.W + 1))
                    rows[p, s, :k] = np.sort(rng.choice(self.N, k, False))
        else:
            spans = self.spans(mode, rng)
        cells, cnt = jax_grouped_windows(triples, valid, pats, pat_valid,
                                         base_vec, spans=spans, rows=rows,
                                         width=self.W)
        mp = tops.padded_pattern_slots(5)
        slots, live = tops.pack_slots(pats, pat_valid, mp)
        assert live == 4                 # one past the last valid slot
        mask, first, tcnt, _ = tops.bindjoin_grouped_cuda(
            tt(triples), tt(valid), tt(slots), tt(base_vec), live=live,
            width=self.W, spans=None if spans is None else tt(spans),
            rows=None if rows is None else tt(rows))
        assert mask.shape == (self.P, self.S, 3, self.W)
        assert mask.dtype == torch.uint8 and tcnt.dtype == torch.int64
        got = torch_grouped_cells(mask, first, spans=spans, rows=rows)
        assert got == cells
        np.testing.assert_array_equal(tcnt.numpy(), cnt)
        assert not mask[:, :, 2].any()   # the padding group keeps nothing
        if base == BASE_VECS[0]:
            assert cells                 # the case keeps some rows

    def test_count_only_sum_equals_cells(self):
        """cnt is a per-(page, shard, group) sum: reordering pages
        reorders it and changes no value."""
        triples, valid, pats, pat_valid = self.inputs(3)
        slots, live = tops.pack_slots(pats, pat_valid, 128)
        spans = self.spans("windowed", None)
        out = [tops.bindjoin_grouped_cuda(
            tt(triples), tt(valid), tt(slots),
            tt(tops.pattern_vec_from((-1, -1, -1))), live=live,
            width=self.W, spans=tt(np.ascontiguousarray(x)))
            for x in (spans, spans[::-1])]
        np.testing.assert_array_equal(out[0][2].numpy(),
                                      out[1][2].numpy()[::-1])


FUSED_CASES = [
    # (tiles, s, g, m, dead tiles)
    (2, 2, 1, 1, 0), (4, 2, 2, 30, 1), (8, 4, 2, 200, 3), (4, 4, 1, 128, 2),
]


class TestBindjoinFused:
    @pytest.mark.parametrize("tiles,s,g,m,dead", FUSED_CASES)
    def test_matches_reference(self, tiles, s, g, m, dead):
        rng = np.random.default_rng(tiles * 100 + s * 10 + g + m)
        bt = jops.DEFAULT_FUSED_BT
        cand = rand_triples(rng, tiles * bt)
        seg_of_tile = rng.integers(0, s, size=tiles).astype(np.int32)
        seg_of_tile[rng.permutation(tiles)[:dead]] = -1
        pats = rand_patterns(rng, (s, g, m))
        valid = (rng.random((s, g, m)) < 0.85).astype(np.int32)
        want = jops.bindjoin_fused(jnp.asarray(cand),
                                   jnp.asarray(seg_of_tile),
                                   jnp.asarray(pats), jnp.asarray(valid))
        got = tops.bindjoin_fused(tt(cand), tt(seg_of_tile), tt(pats),
                                  tt(valid))
        for w, o in zip(want, got, strict=True):
            same(w, o)
        if dead:
            dead_rows = np.repeat(seg_of_tile < 0, bt)
            assert not got[0][torch.as_tensor(dead_rows)].any()


class TestCompactMask:
    @pytest.mark.parametrize("n,capacity", [(1, 1), (50, 50), (50, 80),
                                            (300, 100), (1024, 1024)])
    def test_matches_reference(self, n, capacity):
        rng = np.random.default_rng(n + capacity)
        for frac in (0.0, 0.3, 1.0):
            mask = rng.random(n) < frac
            want_idx, want_count = jops.compact_mask(jnp.asarray(mask),
                                                     capacity)
            got_idx, got_count = tops.compact_mask(tt(mask), capacity)
            same(want_idx, got_idx)
            same(want_count, got_count)

    def test_batched_rows_equal_per_row_calls(self):
        rng = np.random.default_rng(3)
        mask = rng.random((4, 200)) < 0.4
        got_idx, got_count = tops.compact_mask(tt(mask), 200)
        for gi in range(4):
            want_idx, want_count = jops.compact_mask(jnp.asarray(mask[gi]),
                                                     200)
            same(want_idx, got_idx[gi])
            same(want_count, got_count[gi])


class TestRefOracles:
    def test_bindjoin_ref(self):
        rng = np.random.default_rng(21)
        cand = rand_triples(rng, 300)
        pats = rand_patterns(rng, (40,))
        valid = (rng.random(40) < 0.8).astype(np.int32)
        args = [cand[:, i] for i in range(3)] + [pats[:, i] for i in range(3)]
        want = jref.bindjoin_ref(*(jnp.asarray(a) for a in args),
                                 jnp.asarray(valid))
        got = tref.bindjoin_ref(*(tt(a) for a in args), tt(valid))
        for w, o in zip(want, got, strict=True):
            same(w, o)

    def test_bindjoin_fused_ref(self):
        """The fused oracle, per row against its own segment's groups
        (dead rows -1), equals the JAX package's."""
        rng = np.random.default_rng(23)
        cand = rand_triples(rng, 300)
        seg_of_row = rng.integers(-1, 3, size=300).astype(np.int32)
        pats = rand_patterns(rng, (3, 2, 20))
        valid = (rng.random((3, 2, 20)) < 0.8).astype(np.int32)
        args = ([cand[:, i] for i in range(3)] + [seg_of_row]
                + [pats[..., i] for i in range(3)] + [valid])
        want = jref.bindjoin_fused_ref(*(jnp.asarray(a) for a in args))
        got = tref.bindjoin_fused_ref(*(tt(a) for a in args))
        for w, o in zip(want, got, strict=True):
            same(w, o)

    def test_compat_join_ref(self):
        rng = np.random.default_rng(22)
        mu = rng.integers(-1, 4, size=(60, 3)).astype(np.int32)
        omega = rng.integers(-1, 4, size=(25, 3)).astype(np.int32)
        same(jref.compat_join_ref(jnp.asarray(mu), jnp.asarray(omega)),
             tref.compat_join_ref(tt(mu), tt(omega)))

    def test_pattern_vec_and_slot_padding(self):
        assert np.array_equal(tops.pattern_vec_from((1, -1, 2), eq_so=1),
                              jops.pattern_vec_from((1, -1, 2), eq_so=1))
        for m in (1, 30, 128, 129, 200):
            assert tops.padded_pattern_slots(m) \
                == jops.padded_pattern_slots(m)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        rng = np.random.default_rng(1)
        cand = tt(rand_triples(rng, 1024))
        before = (tpf_match_cuda.launches,
                  tbindjoin.bindjoin_grouped_cuda.launches,
                  tbindjoin.bindjoin_fused_cuda.launches)
        tops.tpf_match(cand, tt(tops.pattern_vec_from((-1, 1, -1))))
        tops.bindjoin_grouped(cand, tt(rand_patterns(rng, (2, 3))),
                              torch.ones((2, 3), dtype=torch.int32))
        tops.bindjoin_fused(cand, torch.zeros(4, dtype=torch.int32),
                            tt(rand_patterns(rng, (1, 1, 3))),
                            torch.ones((1, 1, 3), dtype=torch.int32))
        assert (tpf_match_cuda.launches,
                tbindjoin.bindjoin_grouped_cuda.launches,
                tbindjoin.bindjoin_fused_cuda.launches) == before

    def test_no_cuda_device_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.resolve_device(None)
        assert tops.resolve_device("cpu") == torch.device("cpu")

