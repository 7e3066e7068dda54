"""The port's sharded backend against the JAX package's, exactly.

The JAX package runs its ``FederatedStore`` / ``ShardedSelector`` over a
mesh with its Pallas kernels in interpret mode; the port runs the same
store as logical shards with ``device="cpu"`` (the kernels' plain
PyTorch versions). Every output is an integer, so equality is exact:
fragments byte for byte, ``cnt``, ``has_next``, ``LaunchRecord`` lists,
per-shard counters and ``shard_balance``.

* ``ops.bindjoin`` (the ungrouped bind-join) against
  ``repro.kernels.ops.bindjoin`` over the sweep of ``tests/test_kernels.py``;
* one shard against a one-device mesh: ``execute``, ``execute_windowed``,
  ``execute_full``, ``lowerable_windowed`` pages, and the selector's
  grouped, count-only, pruned (with the compact step), fast-path and
  fused launches; servers on the sharded backend (paging, coalescing,
  the ``shards`` metrics section, the async front end's repartition);
* ``plan_windows`` over four shards against the reference's planner;
* ``PageTable`` against the reference's per-page helpers
  (``_page_row_sel``, ``_charge_shard_page``) on hand-built plans;
* four shards end to end: the JAX package under four forced host
  devices, in one subprocess, against the port's four logical shards on
  a manual placement with a replica range (the routed step), on a heat
  placement after ``repartition()``, and on a heterogeneous batch
  through the fused step (no placement), with the port's chunk cap
  whole and forced small.
"""
import asyncio
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.core as jcore
import repro.core.federation as jfed
import repro.core.kernel_selectors as jks
import repro.kernels.ops as jops
from repro.compat import enable_x64
from repro.core.placement import Placement as JPlacement
import repro_torch.core as tcore
import repro_torch.core.federation as tfed
import repro_torch.core.kernel_selectors as tks
import repro_torch.kernels.ops as tops

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
V = jcore.encode_var
UNBOUND = -1


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def rand_triples(rng, t, terms=50):
    return rng.integers(0, terms, size=(t, 3)).astype(np.int32)


def rand_patterns(rng, m, terms=50, wild_frac=0.5):
    pats = rng.integers(0, terms, size=(m, 3)).astype(np.int32)
    pats[rng.random((m, 3)) < wild_frac] = -1
    return pats


def store_array(seed=0, n=500, terms=15):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, terms, size=(n, 3)).astype(np.int32),
                     axis=0)


def rand_omega(rng, m, v=2, terms=15, unbound_frac=0.3):
    om = rng.integers(0, terms, size=(m, v)).astype(np.int32)
    om[rng.random((m, v)) < unbound_frac] = UNBOUND
    return om


def pat(pkg, *comps):
    return pkg.TriplePattern(*comps)


def frag(res):
    data, cnt = res
    return data.dtype.str, data.shape, data.tobytes(), int(cnt)


def records(sel):
    return [dataclasses.asdict(r) for r in sel.launches]


def counters(sel):
    return (sel.shard_launches.tolist(), sel.shard_rows.tolist(),
            sel.shard_pages.tolist(), sel.shard_balance())


# -- the ungrouped bind-join op ----------------------------------------------


class TestBindJoinOp:
    @pytest.mark.parametrize("t", [1, 7, 100, 1024, 2500])
    @pytest.mark.parametrize("m", [1, 5, 30, 128, 200])
    def test_shape_sweep(self, t, m):
        rng = np.random.default_rng(t * 1000 + m)
        cand = rand_triples(rng, t)
        pats = rand_patterns(rng, m)
        valid = (rng.random(m) < 0.9).astype(np.int32)
        self._check(cand, pats, valid)

    def test_all_patterns_invalid(self):
        rng = np.random.default_rng(5)
        self._check(rand_triples(rng, 300), rand_patterns(rng, 40),
                    np.zeros(40, np.int32))

    def test_all_wildcard_pattern(self):
        rng = np.random.default_rng(6)
        pats = rand_patterns(rng, 130)
        pats[129] = -1
        valid = np.zeros(130, np.int32)
        valid[129] = 1
        keep, idx = self._check(rand_triples(rng, 600), pats, valid)
        assert keep.all() and (idx == 129).all()

    @staticmethod
    def _check(cand, pats, valid):
        jkeep, jidx = jops.bindjoin(jnp.asarray(cand), jnp.asarray(pats),
                                    jnp.asarray(valid))
        tkeep, tidx = tops.bindjoin(torch.as_tensor(cand),
                                    torch.as_tensor(pats),
                                    torch.as_tensor(valid))
        assert tkeep.dtype == torch.bool and tidx.dtype == torch.int32
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        # idx includes the no-match value: the padded M, not M or -1
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        return tkeep.numpy(), tidx.numpy()


# -- one shard against a one-device mesh -------------------------------------


def fed_pair(arr, shards=1):
    return (jfed.FederatedStore.build(arr, one_device_mesh()),
            tfed.FederatedStore.build(arr, shards, device="cpu"))


PATTERN_SPECS = [(5, 2, "v0"), (7, "v0", "v1"), ("v0", 3, "v1"),
                 (4, "v0", 9), ("v0", 2, "v0"), ("v0", "v1", "v2")]


def spec_pattern(pkg, spec):
    return pkg.TriplePattern(*[pkg.encode_var(int(c[1:]))
                               if isinstance(c, str) else c for c in spec])


class TestFederatedStore:
    def test_layout_and_keys(self):
        arr = store_array(1, n=300)
        jf = jfed.FederatedStore.build(arr, one_device_mesh())
        tf = tfed.FederatedStore.build(arr, 1, device="cpu")
        assert tf.shards == 1 and tf.shard_n == jf.shard_n
        for name, ix in tf.indexes.items():
            jx = jf.indexes[name]
            n = jf.shard_n
            assert ix.triples.shape == (1, n, 3)
            assert ix.keys.dtype == torch.int64
            np.testing.assert_array_equal(ix.triples.reshape(-1, 3).numpy(),
                                          np.asarray(jx.triples))
            np.testing.assert_array_equal(ix.valid.reshape(-1).numpy(),
                                          np.asarray(jx.valid))
            np.testing.assert_array_equal(ix.host_keys, jx.host_keys)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_execute(self, seed):
        rng = np.random.default_rng(seed)
        arr = store_array(seed, n=400)
        jf, tf = fed_pair(arr)
        omega = rand_omega(rng, 6)
        got = tf.execute(pat(tcore, V(0), 3, V(1)), omega, max_mpr=16,
                         capacity=512)
        want = jf.execute(pat(jcore, V(0), 3, V(1)), omega, max_mpr=16,
                          capacity=512)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("spec", PATTERN_SPECS)
    def test_execute_windowed_multi_page(self, spec):
        rng = np.random.default_rng(5)
        arr = store_array(5, n=3000, terms=30)
        jf, tf = fed_pair(arr)
        omega = rand_omega(rng, 6, terms=30, unbound_frac=0.4)
        for om, window in ((omega, 512), (None, 64)):
            got = tf.execute_windowed(spec_pattern(tcore, spec), om,
                                      max_mpr=16, capacity=64,
                                      window=window)
            want = jf.execute_windowed(spec_pattern(jcore, spec), om,
                                       max_mpr=16, capacity=64,
                                       window=window)
            np.testing.assert_array_equal(got, want)

    def test_execute_windowed_fully_bound_and_empty_range(self):
        arr = store_array(8, n=500, terms=12)
        jf, tf = fed_pair(arr)
        present = arr[3]
        for comps, om, window in [
                (tuple(int(c) for c in present), None, 32),
                ((11, 11, 11), None, 32),
                ((9999, V(0), V(1)), None, 4096),
                ((9999, 1, V(0)), np.array([[3]], np.int32), 16)]:
            got = tf.execute_windowed(pat(tcore, *comps), om, max_mpr=2,
                                      capacity=8, window=window)
            want = jf.execute_windowed(pat(jcore, *comps), om, max_mpr=2,
                                       capacity=8, window=window)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("comps", [(V(0), 3, V(1)), (V(0), 2, V(0)),
                                       (V(0), V(1), V(2))])
    def test_execute_full(self, comps):
        rng = np.random.default_rng(7)
        arr = store_array(7, n=400)
        jf, tf = fed_pair(arr)
        for om in (None, rand_omega(rng, 5)):
            # capacity 64 truncates some shard pages: the same rows drop
            for cap in (64, 1024):
                got = tf.execute_full(pat(tcore, *comps), om, max_mpr=8,
                                      capacity=cap)
                want = jf.execute_full(pat(jcore, *comps), om, max_mpr=8,
                                       capacity=cap)
                np.testing.assert_array_equal(got, want)

    def test_lowerable_windowed_pages(self):
        """The raw single-request step: pages, counts and range lengths
        per window page, including windows that straddle the range end."""
        rng = np.random.default_rng(9)
        arr = store_array(9, n=900)
        jf, tf = fed_pair(arr)
        comps = (V(0), 3, V(1))
        omega = rand_omega(rng, 4)
        pats, valid, bv = tf.request_arrays(pat(tcore, *comps), omega, 8)
        lo, hi = tf.prefix_keys(pat(tcore, *comps), "spo")
        assert (lo, hi) == jf.prefix_keys(pat(jcore, *comps), "spo")
        for window, wild in ((48, (0, 2)), (512, (0, 1, 2))):
            jstep = jf.lowerable_windowed(window, window, wild)
            tstep = tf.lowerable_windowed(window, window, wild)
            pages = -(-tf.shard_n // window) + 1
            for page_idx in range(pages):
                with enable_x64(True):
                    jout = jstep(jf.triples, jf.valid, jf.keys,
                                 jnp.asarray(pats), jnp.asarray(valid),
                                 jnp.asarray(bv), jnp.int64(lo),
                                 jnp.int64(hi), jnp.int32(page_idx))
                tout = tstep(tf.triples, tf.valid, tf.keys,
                             torch.as_tensor(pats), torch.as_tensor(valid),
                             torch.as_tensor(bv), lo, hi, page_idx)
                for j, t in zip(jout, tout, strict=True):
                    np.testing.assert_array_equal(
                        t.numpy(), np.asarray(j).reshape(t.shape))


# -- the selector at one shard -----------------------------------------------


JAX = types.SimpleNamespace(core=jcore, fed=jfed, ks=jks)
TORCH = types.SimpleNamespace(core=tcore, fed=tfed, ks=tks)


def selector(pkg, arr, **kw):
    if pkg is JAX:
        fed = jfed.FederatedStore.build(arr, one_device_mesh())
    else:
        fed = tfed.FederatedStore.build(arr, 1, device="cpu")
    store = pkg.core.TripleStore(arr) if kw.pop("connect", False) else None
    return pkg.fed.ShardedSelector(fed, store=store, **kw)


def assert_same(run):
    """``run(pkg) -> (selector, results)``: results, LaunchRecords and
    per-shard counters must agree."""
    jsel, jres = run(JAX)
    tsel, tres = run(TORCH)
    assert tres == jres
    assert records(tsel) == records(jsel)
    assert counters(tsel) == counters(jsel)
    return tsel


class TestShardedSelector:
    def test_grouped_same_pattern(self):
        rng = np.random.default_rng(9)
        arr = store_array(9, n=700)
        omegas = [None, rand_omega(rng, 6), rand_omega(rng, 12),
                  np.array([[5, UNBOUND]], np.int32)]

        def run(pkg):
            sel = selector(pkg, arr, window=128)
            res = sel.select_same_pattern(pat(pkg.core, V(0), 3, V(1)),
                                          omegas)
            return sel, [frag(r) for r in res]

        tsel = assert_same(run)
        assert all(r.groups == 4 for r in tsel.launches)

    @pytest.mark.parametrize("comps", [(V(0), 3, V(1)), (5, V(0), V(1)),
                                       (V(0), V(1), 7), (V(0), 2, V(0)),
                                       (V(0), V(0), V(1)),
                                       (V(0), V(1), V(2))])
    def test_single_requests(self, comps):
        rng = np.random.default_rng(4)
        arr = store_array(4)
        om = rand_omega(rng, 5, v=3)

        def run(pkg):
            sel = selector(pkg, arr, window=64)
            res = [sel.select_with_cnt(pat(pkg.core, *comps), o)
                   for o in (None, om)]
            return sel, [frag(r) for r in res]

        assert_same(run)

    def test_count_only(self):
        rng = np.random.default_rng(11)
        arr = store_array(11, n=800)
        om = rand_omega(rng, 8)

        def run(pkg):
            sel = selector(pkg, arr, window=64)
            tp = pat(pkg.core, V(0), 4, V(1))
            return sel, [sel.select_count(tp, None), sel.select_count(tp, om)]

        assert_same(run)

    def test_pruned_with_compact_step(self):
        """Bindings that leave large dead gaps inside a window: pages are
        skipped and the remaining ones go through the compact step."""
        s = np.repeat(np.arange(40), 25) + 10
        p = np.tile(np.arange(25), 40) % 5 + 1
        o = np.arange(s.size) + 500
        arr = np.stack([s, p, o], axis=1).astype(np.int32)
        om = np.array([[12, 2], [20, 3], [31, 2], [45, 1]], np.int32)

        def run(pkg):
            sel = selector(pkg, arr, window=256)
            res = [sel.select_with_cnt(pat(pkg.core, V(0), V(1), V(2)), om),
                   sel.select_with_cnt(pat(pkg.core, V(0), 2, V(1)),
                                       om[:, :1])]
            return sel, [frag(r) for r in res]

        tsel = assert_same(run)
        assert any(r.reclaimed_rows > 0 for r in tsel.launches)
        assert any(r.pruned for r in tsel.launches)

    def test_fast_path(self):
        rng = np.random.default_rng(12)
        arr = store_array(12, n=600)
        om = rand_omega(rng, 3)

        def run(pkg):
            sel = selector(pkg, arr, window=64, connect=True,
                           fast_path_rows=64)
            res = [sel.select_with_cnt(pat(pkg.core, 5, 3, V(0)), om[:, :1]),
                   sel.select_with_cnt(pat(pkg.core, V(0), V(1), V(2)),
                                       None)]
            return sel, [frag(r) for r in res]

        tsel = assert_same(run)
        assert any(r.fast_path for r in tsel.launches)
        assert any(not r.fast_path for r in tsel.launches)

    def test_select_fused(self):
        rng = np.random.default_rng(13)
        arr = store_array(13, n=900)
        om = [rand_omega(rng, 6) for _ in range(3)]

        def run(pkg):
            sel = selector(pkg, arr, window=64)
            seg = pkg.ks.FusedSegment
            segs = [seg(pat(pkg.core, V(0), 3, V(1)), [om[0], None]),
                    seg(pat(pkg.core, V(0), 5, V(1)), [om[1]]),
                    seg(pat(pkg.core, V(0), 7, V(1)), [om[2]],
                        count_only=True),
                    seg(pat(pkg.core, 2, V(0), V(1)), [None]),
                    seg(pat(pkg.core, V(0), 4, V(1)), [om[0]],
                        depends_on=())]
            res = sel.select_fused(segs)
            # a dependency refuses fusion: per-segment fallback
            dep = [seg(pat(pkg.core, V(0), 3, V(1)), [om[1]]),
                   seg(pat(pkg.core, V(0), 6, V(1)), [om[2]],
                       depends_on=(0,))]
            res += sel.select_fused(dep)
            return sel, [[frag(r) for r in row] for row in res]

        tsel = assert_same(run)
        assert any(r.segments >= 2 for r in tsel.launches)


# -- grouped launches in chunks of pages ------------------------------------


def selector_placed(pkg, arr, **kw):
    """A one-shard selector on a placement with no replica: every
    request takes the routed step."""
    if pkg is JAX:
        fed = jfed.FederatedStore.build(
            arr, one_device_mesh(),
            placement=JPlacement(boundaries={}))
    else:
        from repro_torch.core.placement import Placement
        fed = tfed.FederatedStore.build(arr, 1, device="cpu",
                                        placement=Placement(boundaries={}))
    return pkg.fed.ShardedSelector(fed, **kw)


def compact_store():
    """40 subjects x 25 rows: bindings of (subject, predicate) pairs
    leave a few live rows in each window page (compact pages)."""
    s = np.repeat(np.arange(40), 25) + 10
    p = np.tile(np.arange(25), 40) % 5 + 1
    o = np.arange(s.size) + 500
    return np.stack([s, p, o], axis=1).astype(np.int32)


class TestChunkedPlans:
    """Plans of many pages with a small window and the chunk cap forced
    to two pages, so chunks break mid-plan: static, routed and pruned
    (compact) plans, grouped and count-only, against the JAX package."""

    @pytest.fixture(autouse=True)
    def two_page_chunks(self, monkeypatch):
        monkeypatch.setattr(tfed, "MAX_CHUNK_ROWS", 2 * 16)

    @pytest.mark.parametrize("routed", [False, True])
    def test_many_pages(self, routed):
        rng = np.random.default_rng(23)
        arr = store_array(23, n=900)
        omegas = [None, rand_omega(rng, 6), rand_omega(rng, 4)]

        def run(pkg):
            make = selector_placed if routed else selector
            sel = make(pkg, arr, window=16)
            res = [sel.select_with_cnt(pat(pkg.core, V(0), V(1), V(2)),
                                       None)]
            res += sel.select_same_pattern(pat(pkg.core, V(0), 3, V(1)),
                                           omegas)
            res.append((np.empty((0, 3), np.int32), sel.select_count(
                pat(pkg.core, V(0), V(1), V(2)), None)))
            return sel, [frag(r) for r in res]

        tsel = assert_same(run)
        pages = len(tsel.launches)
        assert pages > 2 * 4              # plans of many pages
        # two pages (or rounds) per launch: chunks broke mid-plan
        assert 4 < tsel.grouped_chunks < pages

    def test_fused_rounds_in_chunks(self):
        """One order group's fused rounds split across chunks of two
        (round, segment) pages: segments with unequal page counts, two
        groups in one segment, a count-only segment."""
        rng = np.random.default_rng(25)
        arr = store_array(25, n=900)
        om = [rand_omega(rng, 5) for _ in range(2)]

        def run(pkg):
            sel = selector(pkg, arr, window=16)
            seg = pkg.ks.FusedSegment
            res = sel.select_fused([
                seg(pat(pkg.core, V(0), 3, V(1)), [None, om[0]]),
                seg(pat(pkg.core, V(0), 5, V(1)), [om[1]]),
                seg(pat(pkg.core, V(0), 7, V(1)), [None], count_only=True),
                seg(pat(pkg.core, V(0), V(1), V(2)), [None])])
            return sel, [[frag(r) for r in row] for row in res]

        tsel = assert_same(run)
        rounds = [r for r in tsel.launches if r.segments >= 2]
        assert len(rounds) >= 3
        # two pages per chunk: the rounds' pages took more chunks than
        # there are rounds with two or more segments
        assert tsel.fused_chunks > len(rounds)

    def test_count_only_takes_no_compaction(self, monkeypatch):
        """A count-only plan copies back its cnt and nothing else: no
        kept-cell compaction runs, on either backend."""
        arr = store_array(24, n=900)
        tp = pat(tcore, V(0), V(1), V(2))
        sel = selector(TORCH, arr, window=16)
        ksel = tks.KernelSelector(tcore.TripleStore(arr), device="cpu")
        want = [s.select_with_cnt(tp, None)[1] for s in (sel, ksel)]

        def no_compaction(*args, **kwargs):
            raise AssertionError("a count-only plan compacted kept cells")

        monkeypatch.setattr(torch, "nonzero", no_compaction)
        assert [s.select_count(tp, None) for s in (sel, ksel)] == want
        assert want[0] == want[1] > 0

    def test_pruned_compact_pages(self):
        arr = compact_store()
        om = np.array([[12, 2, -1], [20, 3, -1], [31, 2, -1],
                       [45, 1, -1], [13, 4, -1]], np.int32)

        def run(pkg):
            sel = selector(pkg, arr, window=16)
            res = [sel.select_with_cnt(pat(pkg.core, V(0), V(1), V(2)), om),
                   sel.select_with_cnt(pat(pkg.core, V(0), V(1), V(2)),
                                       om[:2, :1])]
            res.append((np.empty((0, 3), np.int32), sel.select_count(
                pat(pkg.core, V(0), V(1), V(2)), om)))
            return sel, [frag(r) for r in res]

        tsel = assert_same(run)
        assert any(r.reclaimed_rows > 0 for r in tsel.launches)
        assert any(r.pruned and not r.reclaimed_rows
                   for r in tsel.launches)

    def test_fused_many_bindings(self):
        """Pruned segments whose groups carry 30 bindings each, so a
        plan holds over a hundred spans: fused rounds in chunks of two
        pages, then the same segments refused fusion by a dependency
        (per-segment launches with compact pages)."""
        # 500 subjects of 18 rows: predicates 1 and 2 once, 3 and 4 in
        # blocks of 8, so 120 bound subjects prune a predicate's range
        p = np.array([1, 2] + [3] * 8 + [4] * 8)
        s = np.repeat(np.arange(500), p.size) + 10
        arr = np.stack([s, np.tile(p, 500), np.arange(s.size) + 9000],
                       axis=1).astype(np.int32)
        rng = np.random.default_rng(29)
        subjects = rng.permutation(500)[:240] + 10
        om = [subjects[30 * k:30 * (k + 1), None].astype(np.int32)
              for k in range(8)]

        def run(pkg):
            sel = selector(pkg, arr, window=16)
            seg = pkg.ks.FusedSegment
            res = sel.select_fused([
                seg(pat(pkg.core, V(0), 3, V(1)), om[:4]),
                seg(pat(pkg.core, V(0), 4, V(1)), om[4:7]),
                seg(pat(pkg.core, V(0), 1, V(1)), om[7:], count_only=True)])
            res += sel.select_fused([
                seg(pat(pkg.core, V(0), 3, V(1)), om[4:]),
                seg(pat(pkg.core, V(0), 4, V(1)), om[:4],
                    depends_on=(0,))])
            return sel, [[frag(r) for r in row] for row in res]

        tsel = assert_same(run)
        insts = [pat(tcore, int(b), 3, V(1)) for o in om[:4] for b in o[:, 0]]
        plan = tsel.fed.plan_windows(pat(tcore, V(0), 3, V(1)), insts, 16)
        assert plan.pruned and len(plan.shard_spans[0]) >= 100
        assert any(r.segments >= 2 for r in tsel.launches)
        assert any(r.reclaimed_rows > 0 for r in tsel.launches)
        assert tsel.fused_chunks > 1 and tsel.grouped_chunks > 1


# -- the page table against the reference's per-page helpers ------------------


def window_plan(pkg, bounds, spans, pages, pruned=True):
    return pkg.fed.WindowPlan(
        order="spo", lo_key=0, hi_key=0, pages=list(pages), range_rows=0,
        candidate_rows=0, pruned=pruned, pages_total=0,
        shard_bounds=list(bounds),
        shard_spans=None if spans is None else [
            np.asarray(x, np.int64).reshape(-1, 2) for x in spans])


def random_spans(rng, start, end, k):
    """Up to ``k`` merged sub-ranges of [start, end)."""
    from repro.core.store import merge_spans
    if end <= start:
        return np.empty((0, 2), np.int64)
    a = rng.integers(start, end, size=k)
    b = np.minimum(a + rng.integers(1, 6, size=k), end)
    return merge_spans(np.stack([a, b], axis=1))


def _random_plan(seed, window):
    rng = np.random.default_rng(seed)
    bounds = [(0, 700), (40, 41), (300, 300), (5, 333)]
    spans = [random_spans(rng, a, b, 150) for a, b in bounds]
    pages = sorted({(lo - a) // window for (a, _), sp in zip(bounds, spans)
                    for lo in sp[:, 0]})
    return bounds, spans, pages


PAGE_TABLE_CASES = {
    # spans crossing page bounds, a last partial page (range 0..38)
    "crossing": (16, [(0, 38)], [[(3, 12), (14, 30), (33, 38)]], range(3)),
    # a range shorter than the window: its first page is its last
    "short_range": (16, [(5, 17), (0, 64)], [[(6, 9)], [(2, 40)]], [0, 1]),
    # a shard with an empty range beside shards with work
    "empty_shard": (8, [(10, 10), (0, 30), (7, 29)],
                    [[], [(0, 2), (9, 11), (25, 30)], [(7, 9), (20, 29)]],
                    [0, 1, 2, 3]),
    "window_1": (1, [(0, 6), (3, 5)], [[(1, 3), (4, 6)], [(3, 4)]],
                 range(6)),
    "window_above_range": (64, [(0, 20), (11, 40)],
                           [[(0, 3), (7, 9)], [(11, 12), (30, 40)]], [0]),
    # widest shard 8 live rows: wc 8 = 16 // 2, compact
    "width_half_window": (16, [(0, 32), (0, 16)],
                          [[(0, 8), (20, 24)], [(3, 5)]], [0, 1]),
    # widest shard 9 live rows: wc 16 > 16 // 2, the page streams
    "width_above_half": (16, [(0, 32), (0, 16)],
                         [[(0, 9), (20, 24)], [(3, 5)]], [0, 1]),
    # an odd window: half of 12 is 6, so only wc 4 and below compact
    "odd_window": (12, [(0, 36)], [[(0, 4), (13, 18), (24, 26)]],
                   range(3)),
    "unpruned": (8, [(0, 30), (4, 4), (2, 9)], None, range(4)),
    "pages_past_a_range": (4, [(0, 40), (0, 6)],
                           [[(1, 2), (30, 39)], [(0, 6)]], [0, 1, 7, 9]),
}


@pytest.mark.parametrize("case", [*PAGE_TABLE_CASES, "random_w16",
                                  "random_w64", "random_pruned_no_spans"])
def test_page_table_matches_per_page_reference(case):
    """``PageTable`` against the JAX package's per-page helpers: each
    page's compact row list (dtype, shape and bytes, or None) and the
    three shard counters, charged as ``_launch_plan`` charges (with the
    row list) and as the fused path does (without)."""
    pruned = True
    if case.startswith("random"):
        window = 64 if case == "random_w64" else 16
        bounds, spans, pages = _random_plan(len(case), window)
        if case == "random_pruned_no_spans":
            spans = None
    else:
        window, bounds, spans, pages = PAGE_TABLE_CASES[case]
        pruned = spans is not None
    jplan = window_plan(JAX, bounds, spans, pages, pruned)
    tplan = window_plan(TORCH, bounds, spans, pages, pruned)
    shards = len(bounds)

    def counters_ns():
        return types.SimpleNamespace(**{
            k: np.zeros((shards,), np.int64)
            for k in ("shard_launches", "shard_rows", "shard_pages")})

    want_sels = [jfed.ShardedSelector._page_row_sel(None, jplan, window, p)
                 for p in pages]
    grouped, fused = counters_ns(), counters_ns()
    for p, sel in zip(pages, want_sels):
        jfed.ShardedSelector._charge_shard_page(grouped, jplan, window, p,
                                                row_sel=sel)
        jfed.ShardedSelector._charge_shard_page(fused, jplan, window, p)

    table = tfed.PageTable(tplan, window, shards)
    got_sels = table.row_lists()
    assert len(got_sels) == len(want_sels)
    for got, want in zip(got_sels, want_sels):
        assert (got is None) == (want is None)
        if want is not None:
            assert (got.dtype, got.shape) == (want.dtype, want.shape)
            assert got.tobytes() == want.tobytes()
    got = counters_ns()
    tfed.ShardedSelector._charge_pages(got, table)
    for want in (grouped, fused):
        for k in ("shard_launches", "shard_rows", "shard_pages"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    compact = [sel is not None for sel in got_sels]
    if case == "crossing":
        assert compact == [False, False, True]
    if case.startswith("width_"):
        assert compact[0] == (case == "width_half_window")


# -- servers on the sharded backend ------------------------------------------


def server_pair(arr, **cfg):
    jsrv = jcore.BrTPFServer(jcore.TripleStore(arr), jcore.ServerConfig(
        selector_backend="sharded", **cfg))
    tsrv = tcore.BrTPFServer(tcore.TripleStore(arr), tcore.ServerConfig(
        selector_backend="sharded", device="cpu", **cfg))
    return jsrv, tsrv


def fragment_tuple(f):
    return (f.data.tobytes(), f.data.shape, f.cnt, f.has_next,
            f.triples_received)


class TestServer:
    def test_paging(self):
        rng = np.random.default_rng(11)
        arr = store_array(10, n=900)
        jsrv, tsrv = server_pair(arr, page_size=20, shard_window=128)
        om = rand_omega(rng, 8)
        om[0] = UNBOUND
        for omega in (om, None):
            page = 0
            while True:
                fj = jsrv.handle(jcore.Request(
                    pat(jcore, V(0), 3, V(1)), omega, page))
                ft = tsrv.handle(tcore.Request(
                    pat(tcore, V(0), 3, V(1)), omega, page))
                assert fragment_tuple(ft) == fragment_tuple(fj)
                if not fj.has_next:
                    break
                page += 1
        assert page >= 1
        assert records(tsrv._selector) == records(jsrv._selector)
        assert dataclasses.asdict(tsrv.counters) \
            == dataclasses.asdict(jsrv.counters)

    @pytest.mark.parametrize("fuse", [True, False])
    def test_handle_batch_coalescing(self, fuse):
        rng = np.random.default_rng(13)
        arr = store_array(13, n=900)
        jsrv, tsrv = server_pair(arr, shard_window=128, fuse_patterns=fuse)
        oms = [rand_omega(rng, 6) for _ in range(3)]

        def reqs(core):
            a = pat(core, V(0), 3, V(1))
            b = pat(core, V(0), 5, V(1))
            return [core.Request(a, oms[0], 0), core.Request(a, oms[1], 0),
                    core.Request(b, oms[2], 0), core.Request(a, None, 0)]

        got = tsrv.handle_batch(reqs(tcore))
        want = jsrv.handle_batch(reqs(jcore))
        assert [fragment_tuple(f) for f in got] \
            == [fragment_tuple(f) for f in want]
        assert records(tsrv._selector) == records(jsrv._selector)
        assert dataclasses.asdict(tsrv.counters) \
            == dataclasses.asdict(jsrv.counters)
        assert tsrv.metrics_snapshot()["shards"] \
            == jsrv.metrics_snapshot()["shards"]
        assert (tsrv.counters.fused_launches >= 1) == fuse

    def test_async_front_end_and_repartition(self):
        rng = np.random.default_rng(17)
        arr = store_array(17, n=700)
        jsrv, tsrv = server_pair(arr, shard_window=32,
                                 placement_policy="heat")
        streams = [[(V(0), 3, V(1)), rand_omega(rng, 4)],
                   [(2, V(0), V(1)), None], [(V(0), 5, V(1)), None]]

        def drive(core, srv):
            front = core.AsyncBrTPFServer(srv)

            async def main():
                try:
                    out = [await asyncio.gather(*[
                        front.handle(core.Request(pat(core, *c), om, 0))
                        for c, om in streams])]
                    await front.repartition()
                    out.append(await asyncio.gather(*[
                        front.handle(core.Request(pat(core, *c), om, 0))
                        for c, om in streams]))
                    return out
                finally:
                    await front.aclose()

            rounds = asyncio.run(main())
            return [[fragment_tuple(f) for f in r] for r in rounds]

        assert drive(tcore, tsrv) == drive(jcore, jsrv)
        assert records(tsrv._selector) == records(jsrv._selector)
        assert tsrv.metrics_snapshot()["shards"] \
            == jsrv.metrics_snapshot()["shards"]
        assert tsrv.federated.placement is not None

    def test_client_trace_records_shard_pages(self):
        arr = store_array(19, n=600)
        jsrv, tsrv = server_pair(arr, shard_window=64)

        def trace(core, srv):
            bgp = core.bgp_from_arrays([(V(0), 3, V(1)), (V(1), 4, V(2))])
            log = []
            res = core.BrTPFClient(
                srv, tick=lambda kind, units: log.append((kind, units))
            ).execute(bgp)
            return res.solutions.tolist(), [
                list(r["shard_pages"]) for kind, r in log if kind == "http"]

        got, want = trace(tcore, tsrv), trace(jcore, jsrv)
        assert got == want
        assert any(sum(p) for p in got[1])


# -- the planner over four shards --------------------------------------------


def block_triples(n_subj=8, per_subj=8):
    s = np.repeat(np.arange(n_subj), per_subj) + 10
    p = np.tile(np.arange(per_subj), n_subj) % 4 + 1
    o = np.arange(s.size) + 500
    return np.stack([s, p, o], axis=1).astype(np.int32)


def host_only_pair(triples, splits):
    """Reference and port stores that hold only the per-order host keys,
    with non-uniform per-shard key counts (``splits`` are boundary
    positions into each order's sorted keys)."""
    from repro.core.store import _ORDERS, _pack
    shards = len(splits) + 1
    parts = {}
    for name, comp in _ORDERS.items():
        keys = np.sort(_pack(triples[:, comp[0]], triples[:, comp[1]],
                             triples[:, comp[2]]).astype(np.int64))
        parts[name] = np.split(keys, splits)
    shard_n = max(p.size for ps in parts.values() for p in ps)
    jix, tix = {}, {}
    for name, ps in parts.items():
        hk = np.full((shards, shard_n), np.iinfo(np.int64).max, np.int64)
        for s, p in enumerate(ps):
            hk[s, :p.size] = p
        jix[name] = jfed.ShardIndex(name, None, None, None, hk)
        tix[name] = tfed.ShardIndex(name, None, None, None, hk)
    mesh = types.SimpleNamespace(shape={"data": shards})
    jf = jfed.FederatedStore(mesh=mesh, axis="data", triples=None,
                             valid=None, keys=None, shard_n=shard_n,
                             indexes=jix)
    tf = tfed.FederatedStore(shards=shards, device=torch.device("cpu"),
                             triples=None, valid=None, keys=None,
                             shard_n=shard_n, indexes=tix)
    return jf, tf


def plan_tuple(plan):
    d = dataclasses.asdict(plan)
    spans = d.pop("shard_spans")
    d["shard_spans"] = None if spans is None else [
        np.asarray(x).tolist() for x in spans]
    return d


@pytest.mark.parametrize("splits", [[16, 32, 48], [40, 52, 60], [3, 4, 5]])
@pytest.mark.parametrize("window", [0, 2, 4, 10_000])
def test_plan_windows_four_shards(splits, window):
    triples = block_triples()
    jf, tf = host_only_pair(triples, splits)
    cases = [
        ((12, V(0), V(1)), None),
        ((15, V(0), V(1)), None),
        ((V(0), 3, V(1)), None),
        ((12, V(0), V(1)), [(12, 1, V(1)), (12, 3, V(1))]),
        ((V(0), V(1), V(2)), [(13, V(1), V(2)), (16, V(1), V(2))]),
        ((V(0), 2, V(1)), [(V(0), 2, 530), (V(0), 2, 562)]),
    ]
    for comps, inst in cases:
        plans = []
        for core, fed in ((jcore, jf), (tcore, tf)):
            tp = pat(core, *comps)
            insts = [tp] if inst is None else [pat(core, *c) for c in inst]
            plans.append(plan_tuple(fed.plan_windows(tp, insts, window)))
        assert plans[1] == plans[0], comps


# -- four shards end to end --------------------------------------------------

_FOUR_SHARDS = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import json
import numpy as np, jax
import repro.core as core
from repro.core.federation import FederatedStore
from repro.core.placement import Placement, ReplicaRange
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[1])))
assert len(jax.devices()) == 4
import scenario
out = scenario.run(core, FederatedStore, Placement, ReplicaRange,
                   lambda srv: srv.federated.mesh)
with open(sys.argv[2], "w") as fh:
    json.dump(out, fh)
"""

# The scenario both packages run. It names the server factory's only
# backend-specific argument through ``mesh_of`` (the JAX package keeps
# its mesh; the port passes its shard count).
_SCENARIO = r'''
import numpy as np

V_ = None


def frag(f):
    return [f.data.tolist(), list(f.data.shape), int(f.cnt),
            bool(f.has_next)]


def run(core, FederatedStore, Placement, ReplicaRange, mesh_of, **cfg):
    from dataclasses import asdict
    V = core.encode_var
    n_subj, per_subj = 64, 8
    s = np.repeat(np.arange(n_subj), per_subj) + 100
    p = np.tile(np.arange(per_subj), n_subj) % 4 + 1
    o = np.arange(s.size) + 10_000
    store = core.TripleStore(np.stack([s, p, o], axis=1).astype(np.int32))
    from repro_keys import dataset_keys
    keys = dataset_keys(store.triples)["spo"]
    out = {}

    # manual placement: non-uniform cuts + a replica range (routed step)
    n = keys.size
    cuts = np.array([keys[n // 2], keys[5 * n // 8], keys[6 * n // 8]],
                    dtype=np.int64)
    lo_key = int(keys[10 * per_subj])
    hi_key = int(keys[12 * per_subj - 1])
    manual = Placement(
        boundaries={"spo": cuts},
        replicas={"spo": (ReplicaRange("spo", lo_key, hi_key, home=0,
                                       replicas=(2,)),)})
    srv = core.BrTPFServer(store, core.ServerConfig(
        selector_backend="sharded", shard_window=16, **cfg))
    placed = FederatedStore.build(store.triples, mesh_of(srv),
                                  placement=manual)
    srv.federated = placed
    srv._selector.rebind(placed)
    srv.fragments.clear()
    om = np.array([[2, -1], [3, -1]], np.int32)
    hot = [core.Request(core.TriplePattern(100 + subj, V(0), V(1)),
                        np.roll(om, k, axis=0), page=0)
           for subj in (10, 11) for k in (0, 1)]
    cold = [core.Request(core.TriplePattern(100 + subj, V(0), V(1)), om, 0)
            for subj in (5, 40, 60)]
    wide = [core.Request(core.TriplePattern(V(0), 2, V(1)), None, pg)
            for pg in range(3)]
    out["manual"] = [frag(srv.handle(r)) for r in hot * 3 + cold + wide]
    batch = [core.Request(core.TriplePattern(110, V(0), V(1)), om[:1], 0),
             core.Request(core.TriplePattern(V(0), 3, V(1)), None, 0),
             core.Request(core.TriplePattern(111, V(0), V(1)), om, 0)]
    out["manual_batch"] = [frag(f) for f in srv.handle_batch(batch)]
    out["manual_launches"] = [asdict(r) for r in srv._selector.launches]
    out["manual_shards"] = srv.metrics_snapshot()["shards"]
    out["manual_pages"] = srv.shard_launch_snapshot().tolist()

    # heat placement: traffic, repartition(), traffic again
    rng = np.random.default_rng(7)
    live = core.BrTPFServer(store, core.ServerConfig(
        selector_backend="sharded", shard_window=16,
        placement_policy="heat", **cfg))
    ranks = np.arange(1, n_subj + 1, dtype=np.float64)
    wts = ranks ** -2.0
    wts /= wts.sum()

    def traffic(k):
        reqs = []
        for _ in range(k):
            subj = int(rng.choice(n_subj, p=wts)) + 100
            pr = rng.choice(4, size=2, replace=False) + 1
            omega = np.array([[int(x), -1] for x in pr], np.int32)
            reqs.append(core.Request(core.TriplePattern(subj, V(0), V(1)),
                                     omega, 0))
        return reqs

    out["heat_before"] = [frag(live.handle(r)) for r in traffic(40)]
    out["heat_uniform"] = live.metrics_snapshot()["shards"]
    live.repartition()
    live.reset_counters()
    placement = live.federated.placement
    out["heat_bounds"] = {k: np.asarray(v).tolist()
                          for k, v in placement.boundaries.items()}
    out["heat_replicas"] = {k: [[r.lo_key, r.hi_key, r.home,
                                 list(r.replicas)] for r in v]
                            for k, v in placement.replicas.items()}
    out["heat_shard_n"] = live.federated.shard_n
    out["heat_after"] = [frag(live.handle(r)) for r in traffic(40)]
    out["heat_shards"] = live.metrics_snapshot()["shards"]
    out["heat_launches"] = [asdict(r) for r in live._selector.launches]

    # many pages per request (small windows): unpruned, pruned with
    # compact pages, grouped with a padding group, count-only
    om_sp = np.array([[110, 2, -1], [130, 3, -1], [150, 1, -1],
                      [151, 1, -1]], np.int32)
    om_s = [np.array([[110, -1], [111, -1]], np.int32),
            np.array([[140, -1]], np.int32)]
    for window in (4, 16):
        paged = core.BrTPFServer(store, core.ServerConfig(
            selector_backend="sharded", shard_window=window, **cfg))
        sel = paged._selector
        res = [sel.select_with_cnt(core.TriplePattern(V(0), 2, V(1)), None),
               sel.select_with_cnt(core.TriplePattern(V(0), V(1), V(2)),
                                   om_sp)]
        res += sel.select_same_pattern(core.TriplePattern(V(0), 2, V(1)),
                                       [None, *om_s])
        out[f"paged_{window}"] = [[d.tolist(), int(c)] for d, c in res] + [
            int(sel.select_count(core.TriplePattern(V(0), 1, V(1)), None))]
        out[f"paged_{window}_launches"] = [asdict(r) for r in sel.launches]
        out[f"paged_{window}_shards"] = paged.metrics_snapshot()["shards"]

    # a heterogeneous batch on the fused step (no placement): a POS order
    # group of segments with unequal page counts (two whole predicates, a
    # pruned segment of two groups, a count-only segment) and an SPO
    # order group whose segments lie on different shards
    for window in (4, 16):
        fused = core.BrTPFServer(store, core.ServerConfig(
            selector_backend="sharded", shard_window=window,
            fuse_patterns=True, **cfg))
        tp = core.TriplePattern
        batch = [core.Request(tp(V(0), 2, V(1)), None, 0),
                 core.Request(tp(V(0), 3, V(1)), None, 0),
                 core.Request(tp(V(0), 1, V(1)),
                              np.array([[-1, 10000], [-1, 10040]],
                                       np.int32), 0),
                 core.Request(tp(V(0), 1, V(1)),
                              np.array([[-1, 10004]], np.int32), 0),
                 core.Request(tp(V(0), 4, V(1)), None, 0, count_only=True),
                 core.Request(tp(110, V(0), V(1)),
                              np.array([[2, -1], [3, -1]], np.int32), 0),
                 core.Request(tp(150, V(0), V(1)), None, 0)]
        out[f"fused_{window}"] = [frag(f) for f in fused.handle_batch(batch)]
        out[f"fused_{window}_launches"] = [
            asdict(r) for r in fused._selector.launches]
        out[f"fused_{window}_shards"] = fused.metrics_snapshot()["shards"]
        out[f"fused_{window}_pages"] = fused.shard_launch_snapshot().tolist()
        out[f"fused_{window}_counters"] = asdict(fused.counters)
        out[f"fused_{window}_chunks"] = getattr(fused._selector,
                                                "fused_chunks", None)
    return out
'''


@pytest.fixture(scope="module")
def four_shard_runs(tmp_path_factory):
    """Run the scenario on the JAX package under four forced host
    devices (one subprocess), and on the port's four logical shards."""
    tmp = tmp_path_factory.mktemp("four_shards")
    scen = _SCENARIO.replace(
        "from repro_keys import dataset_keys",
        "from repro.core.placement import dataset_keys")
    (tmp / "scenario.py").write_text(scen)
    (tmp / "main.py").write_text(_FOUR_SHARDS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(tmp / "main.py"), str(tmp / "scenario.py"),
         str(tmp / "ref.json")], env=env, capture_output=True, text=True,
        timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads((tmp / "ref.json").read_text())

    ns = {}
    exec(compile(_SCENARIO.replace(
        "from repro_keys import dataset_keys",
        "from repro_torch.core.placement import dataset_keys"),
        "scenario", "exec"), ns)
    from repro_torch.core.placement import Placement, ReplicaRange

    def build(triples, shards, placement):
        return tfed.FederatedStore.build(triples, shards, device="cpu",
                                         placement=placement)

    def run():
        return json.loads(json.dumps(ns["run"](
            tcore, types.SimpleNamespace(build=build), Placement,
            ReplicaRange, lambda srv: srv.federated.shards, shards=4,
            device="cpu")))

    got = run()
    # again with one 4-shard page (or round) of 16 rows per grouped
    # launch, and four of the 4-row windows, so the chunks break mid-plan
    cap = tfed.MAX_CHUNK_ROWS
    tfed.MAX_CHUNK_ROWS = 4 * 16
    try:
        chunked = run()
    finally:
        tfed.MAX_CHUNK_ROWS = cap
    return got, want, chunked


SCENARIO_KEYS = [
    "manual", "manual_batch", "manual_launches", "manual_shards",
    "manual_pages", "heat_before", "heat_uniform", "heat_bounds",
    "heat_replicas", "heat_shard_n", "heat_after", "heat_shards",
    "heat_launches", "paged_4", "paged_4_launches", "paged_4_shards",
    "paged_16", "paged_16_launches", "paged_16_shards",
    "fused_4", "fused_4_launches", "fused_4_shards", "fused_4_pages",
    "fused_4_counters", "fused_16", "fused_16_launches", "fused_16_shards",
    "fused_16_pages", "fused_16_counters"]


@pytest.mark.parametrize("key", SCENARIO_KEYS)
def test_four_shards_end_to_end(four_shard_runs, key):
    got, want, _ = four_shard_runs
    assert got[key] == want[key]


@pytest.mark.parametrize("key", SCENARIO_KEYS)
def test_four_shards_in_small_chunks(four_shard_runs, key):
    """The same scenario with the chunk cap forced down to a few pages:
    the results and the accounting do not depend on how pages are
    chunked."""
    _, want, chunked = four_shard_runs
    assert chunked[key] == want[key]


def test_four_shard_scenario_exercises_routing(four_shard_runs):
    got, _, _ = four_shard_runs
    paged = got["paged_4_launches"]
    assert len(paged) > 8 and any(r["reclaimed_rows"] for r in
                                  got["paged_16_launches"])
    pages = got["manual_pages"]
    # the replicated block is charged to both holders {0, 2}
    assert pages[0] > 0 and pages[2] > 0
    assert got["heat_shards"]["imbalance"] < got["heat_uniform"]["imbalance"]


@pytest.mark.parametrize("window", [4, 16])
def test_four_shard_fused_rounds_in_chunks(four_shard_runs, window):
    """The fused batch ran fused rounds of several segments on the port:
    one fused launch per chunk of an order group's rounds, fewer than the
    rounds, and more chunks once the cap breaks the rounds apart."""
    got, want, chunked = four_shard_runs
    rounds = [r for r in got[f"fused_{window}_launches"]
              if r["segments"] >= 2]
    assert rounds and got[f"fused_{window}_counters"]["fused_launches"]
    assert want[f"fused_{window}_chunks"] is None     # the JAX package
    assert 2 <= got[f"fused_{window}_chunks"] < len(rounds)
    assert chunked[f"fused_{window}_chunks"] > got[f"fused_{window}_chunks"]
    # the count-only segment's cnt came back, and its page is empty
    count_only = got[f"fused_{window}"][4]
    assert count_only[2] > 0 and count_only[0] == []
