"""The port's KernelSelector against the JAX package's, exactly.

Both selectors run over stores built from the same triple array, on the
same requests: the JAX selector with its Pallas kernels in interpret
mode, the port's with ``device="cpu"`` (the kernels' plain PyTorch
versions). Fragments must be byte-identical, ``cnt`` equal and the
``LaunchRecord`` lists equal. The cases are those of
``tests/test_kernel_selectors.py``, ``tests/test_pruning.py`` and
``tests/test_fusion.py``.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

import repro.core as jcore
import repro.core.kernel_selectors as jks
import repro_torch.core as tcore
import repro_torch.core.kernel_selectors as tks

pytestmark = pytest.mark.tier1

UNBOUND = -1
V = jcore.encode_var
assert tcore.encode_var(3) == V(3) and tcore.UNBOUND == UNBOUND

JAX = types.SimpleNamespace(
    TriplePattern=jcore.TriplePattern, TripleStore=jcore.TripleStore,
    KernelSelector=jks.KernelSelector, FusedSegment=jks.FusedSegment,
    brtpf_select_with_cnt=jcore.brtpf_select_with_cnt)
TORCH = types.SimpleNamespace(
    TriplePattern=tcore.TriplePattern, TripleStore=tcore.TripleStore,
    KernelSelector=functools.partial(tks.KernelSelector, device="cpu"),
    FusedSegment=tks.FusedSegment,
    brtpf_select_with_cnt=tcore.brtpf_select_with_cnt)


def store_array(seed=0, n=500, terms=15):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, terms, size=(n, 3)).astype(np.int32),
                     axis=0)


def rand_omega(rng, m, v=2, terms=15, unbound_frac=0.3):
    om = rng.integers(0, terms, size=(m, v)).astype(np.int32)
    om[rng.random((m, v)) < unbound_frac] = UNBOUND
    return om


def rand_pattern(rng, terms=15, max_vars=3):
    return tuple(V(int(rng.integers(0, max_vars))) if rng.random() < 0.5
                 else int(rng.integers(0, terms)) for _ in range(3))


def fragment_bytes(res):
    data, cnt = res
    assert isinstance(cnt, int)
    return data.dtype.str, data.shape, data.tobytes(), cnt


def assert_same_run(run):
    """``run(pkg) -> (selector, results)``; results is a list (or list
    of lists) of (data, cnt). Compares results and LaunchRecords."""
    jsel, jres = run(JAX)
    tsel, tres = run(TORCH)

    def flat(res):
        if res and isinstance(res[0], list):
            return [fragment_bytes(r) for row in res for r in row]
        return [fragment_bytes(r) for r in res]

    assert flat(tres) == flat(jres)
    assert [dataclasses.asdict(r) for r in tsel.launches] \
        == [dataclasses.asdict(r) for r in jsel.launches]
    return tsel, tres


def single(arr, tp, omega, **kw):
    def run(pkg):
        sel = pkg.KernelSelector(pkg.TripleStore(arr), **kw)
        return sel, [sel.select_with_cnt(pkg.TriplePattern(*tp), omega)]
    return run


def _single_cases():
    rng = np.random.default_rng(1)
    cases = [
        ("empty_omega_none", store_array(), (V(0), 3, V(1)), None),
        ("empty_omega_rows", store_array(), (V(0), 3, V(1)),
         np.empty((0, 2), np.int32)),
        ("full_wildcard", store_array(1), (V(0), V(1), V(2)),
         rand_omega(rng, 6, v=3)),
        ("repeated_o", store_array(4), (V(0), 2, V(0)),
         rand_omega(rng, 5, v=1)),
        ("repeated_sp", store_array(4), (V(0), V(0), V(1)),
         rand_omega(rng, 5)),
        ("repeated_spo", store_array(4), (V(0), V(0), V(0)),
         rand_omega(rng, 5, v=1)),
        ("stream_index_change", store_array(5), (V(0), 3, V(1)),
         np.array([[5, UNBOUND]], np.int32)),
        ("max_mpr_omega", store_array(6, n=800), (V(0), 3, V(1)),
         rand_omega(rng, 30)),
        ("no_matches", store_array(7), (V(0), 14, 9999),
         rand_omega(rng, 6)),
        ("empty_store", np.empty((0, 3), np.int32), (V(0), 3, V(1)),
         rand_omega(rng, 6)),
        ("duplicate_mappings", store_array(8), (V(0), 3, V(1)),
         np.array([[2, UNBOUND], [2, UNBOUND], [UNBOUND, 4],
                   [2, UNBOUND]], np.int32)),
        ("cnt_cross_stream", np.array([[1, 2, 3], [1, 2, 4], [5, 2, 3]],
                                      np.int32), (V(0), 2, V(1)),
         np.array([[1, UNBOUND], [UNBOUND, 3]], np.int32)),
        ("pruned_uniform", store_array(6, n=700), (V(0), 3, V(1)),
         np.array([[5, UNBOUND], [7, UNBOUND], [2, UNBOUND]], np.int32)),
        ("pruned_absent_values", store_array(8), (V(0), 3, V(1)),
         np.array([[9999, UNBOUND], [8888, UNBOUND]], np.int32)),
        ("pruned_mixed_shape", store_array(9, n=700), (V(0), 3, V(1)),
         np.array([[5, UNBOUND], [UNBOUND, 4], [2, 9]], np.int32)),
    ]
    for seed in (0, 1):
        prng = np.random.default_rng(seed)
        arr = store_array(seed)
        for i, tp in enumerate([(V(0), 3, V(1)), (5, V(0), V(1)),
                                (V(0), V(1), 7), (5, 3, V(0))]):
            cases.append((f"typical_{seed}_{i}", arr, tp,
                          rand_omega(prng, 6)))
    for seed in (2, 3):
        prng = np.random.default_rng(seed)
        arr = store_array(seed, n=600)
        for i in range(3):
            tp = rand_pattern(prng)
            m = int(prng.integers(0, 8))
            om = None if m == 0 else rand_omega(prng, m, v=3,
                                               unbound_frac=0.4)
            cases.append((f"random_{seed}_{i}", arr, tp, om))
    return cases


SINGLE_CASES = _single_cases()


class TestSelectWithCnt:
    @pytest.mark.parametrize("name,arr,tp,omega", SINGLE_CASES,
                             ids=[c[0] for c in SINGLE_CASES])
    def test_matches_jax_selector(self, name, arr, tp, omega):
        assert_same_run(single(arr, tp, omega))

    def test_equals_numpy_oracle(self):
        arr = store_array(6, n=700)
        tp = (V(0), 3, V(1))
        om = np.array([[5, UNBOUND], [7, UNBOUND], [2, UNBOUND]], np.int32)
        tsel, [(data, cnt)] = assert_same_run(single(arr, tp, om))
        assert tsel.launches[-1].pruned
        want, wcnt = tcore.brtpf_select_with_cnt(
            tcore.TripleStore(arr), tcore.TriplePattern(*tp), om)
        np.testing.assert_array_equal(data, want)
        assert cnt == wcnt

    def test_fast_path_records_decision(self):
        arr = store_array(13, n=700)
        tp = (V(0), 3, V(1))
        om = np.array([[5, UNBOUND], [7, UNBOUND]], np.int32)
        tsel, _ = assert_same_run(single(arr, tp, om,
                                         fast_path_rows=10**9))
        assert tsel.launches[-1].fast_path


class TestGroupedAndCount:
    def test_batch_mixed_tpf_and_pruned(self):
        rng = np.random.default_rng(10)
        arr = store_array(10, n=700)
        omegas = [None, np.array([[5, UNBOUND], [2, UNBOUND]], np.int32),
                  rand_omega(rng, 6), rand_omega(rng, 30),
                  np.array([[5, UNBOUND]], np.int32)]

        def run(pkg):
            sel = pkg.KernelSelector(pkg.TripleStore(arr))
            return sel, sel.select_same_pattern(
                pkg.TriplePattern(V(0), 3, V(1)), omegas)

        tsel, _ = assert_same_run(run)
        assert len(tsel.launches) == 1
        assert tsel.launches[0].groups == len(omegas)

    @pytest.mark.parametrize("omega", [None, "rand"])
    def test_select_count(self, omega):
        rng = np.random.default_rng(12)
        arr = store_array(12, n=700)
        om = None if omega is None else rand_omega(rng, 7)

        def run(pkg):
            sel = pkg.KernelSelector(pkg.TripleStore(arr))
            tp = pkg.TriplePattern(V(0), 3, V(1))
            return sel, [(np.empty((0, 3), np.int32),
                          sel.select_count(tp, om))]

        assert_same_run(run)


def _segments(pkg, rng, preds=(2, 3, 5), depends=(), count=(), omega_m=4):
    return [pkg.FusedSegment(
        tp=pkg.TriplePattern(V(0), p, V(1)),
        omegas=[rand_omega(rng, omega_m), None],
        count_only=i in count,
        depends_on=(0,) if i in depends else ())
        for i, p in enumerate(preds)]


class TestSelectFused:
    @pytest.mark.parametrize("kw", [
        dict(),
        dict(count=(1,)),
        dict(preds=(2, 3, 5, 7, 11), omega_m=30),
        dict(depends=(2,)),                   # legality fallback
        dict(preds=tuple(range(15))),         # 15 segments, one launch
    ], ids=["fuse3", "count_segment", "fuse5_mpr", "dependent_fallback",
            "many_segments"])
    def test_matches_jax_selector(self, kw):
        arr = store_array(7, n=600)

        def run(pkg):
            sel = pkg.KernelSelector(pkg.TripleStore(arr))
            segs = _segments(pkg, np.random.default_rng(7), **kw)
            return sel, sel.select_fused(segs)

        tsel, _ = assert_same_run(run)
        fused = [r for r in tsel.launches if r.segments >= 2]
        assert len(fused) == (0 if "depends" in kw else 1)

    def test_hetero_segments_with_repeated_variables(self):
        arr = store_array(3, n=600)

        def run(pkg):
            rng = np.random.default_rng(3)
            tp = pkg.TriplePattern
            segs = [
                pkg.FusedSegment(tp(V(0), 4, V(0)),
                                 [rand_omega(rng, 5, v=1)]),
                pkg.FusedSegment(tp(V(0), V(1), V(2)),
                                 [rand_omega(rng, 3, v=3)]),
                pkg.FusedSegment(tp(5, V(0), V(1)),
                                 [rand_omega(rng, 4), None]),
                pkg.FusedSegment(tp(V(0), V(0), V(1)), [None],
                                 count_only=True),
            ]
            sel = pkg.KernelSelector(pkg.TripleStore(arr))
            return sel, sel.select_fused(segs)

        assert_same_run(run)

