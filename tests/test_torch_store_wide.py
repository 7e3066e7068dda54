"""The store's key layout past 21-bit term ids, on the CPU.

Hand-made stores whose ids reach 2**30, 2**31 - 1, and the shape of the
benchmark's 92M-triple deployment (subjects and objects over 25 bits,
ten predicates numbered after the entities): the ``TripleStore``, the
kernel selector and the sharded store (``device="cpu"``, the kernels'
plain versions) give the pages, ``cnt`` and BGP solutions of a scan of
every triple written here, and of the benchmark's NumPy reference.
Constants outside a column's range give empty pages with ``cnt`` 0;
columns whose ranges need more than 63 bits together raise. At 21-bit
ids the layout's keys are the JAX package's, bit for bit: only that test
imports it.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import repro_torch.core as tcore
from repro_torch.core import metrics, store as tstore
from repro_torch.core.federation import FederatedStore, ShardedSelector
from repro_torch.core.kernel_selectors import KernelSelector

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from bench import reference  # noqa: E402

pytestmark = pytest.mark.tier1

V = tcore.encode_var
ORDERS = {"spo": (0, 1, 2), "pos": (1, 2, 0), "osp": (2, 0, 1)}
# The benchmark's deployment at 6000x: entity ids below ENTITIES, then
# the ten predicates, then the classes (bench/datagen.py's layout).
ENTITIES = 18_870_005


def _shape_6000x(rng):
    subjects = rng.choice(18_120_000, 24, replace=False)
    subjects[:2] = (0, 18_119_999)
    objects = np.concatenate([subjects[:12],
                              rng.choice(ENTITIES + 14, 12, replace=False)])
    objects[-1] = ENTITIES + 13
    return subjects, ENTITIES + np.arange(10), objects


def _band(top):
    def make(rng):
        pool = top - rng.choice(1 << 22, 24, replace=False)
        pool[0] = top
        return pool, top - np.arange(4), pool
    return make


SHAPES = {"2^30": _band(1 << 30), "2^31-1": _band((1 << 31) - 1),
          "6000x": _shape_6000x}


def _triples(shape, n=260, seed=0):
    """Repeated rows included: the store keeps each once."""
    rng = np.random.default_rng(seed)
    subjects, preds, objects = SHAPES[shape](rng)
    t = np.stack([rng.choice(subjects, n), rng.choice(preds, n),
                  rng.choice(objects, n)], axis=1)
    return np.concatenate([t, t[:20]]).astype(np.int32), subjects, preds


@pytest.fixture(params=sorted(SHAPES), scope="module")
def wide(request):
    triples, subjects, preds = _triples(request.param)
    store = tcore.TripleStore(triples)
    rows = sorted(set(map(tuple, triples.tolist())))
    return dict(name=request.param, triples=triples, rows=rows,
                store=store, subjects=subjects, preds=preds,
                ref=reference.ReferenceStore(triples))


def scan(rows, pattern):
    """Matches of ``pattern`` by a scan of every row, in the order of the
    index the store streams it from (SPO, POS, OSP: the first with the
    longest bound prefix)."""
    keep = [r for r in rows
            if all(c < 0 or r[i] == c for i, c in enumerate(pattern))
            and all(r[i] == r[j] for i in range(3) for j in range(3)
                    if pattern[i] < 0 and pattern[i] == pattern[j])]
    best, order = -1, None
    for perm in ORDERS.values():
        plen = next((k for k, c in enumerate(perm) if pattern[c] < 0), 3)
        if plen > best:
            best, order = plen, perm
    return sorted(keep, key=lambda r: [r[c] for c in order])


def scan_fragment(rows, pattern, omega):
    """The brTPF fragment by scans: each distinct instantiation's
    stream in turn, each row kept where it first occurs, and ``cnt`` the
    streams' summed sizes."""
    if omega is None:
        insts = [tuple(pattern)]
    else:
        insts = list(dict.fromkeys(
            tuple(int(om[-c - 1]) if c < 0 and om[-c - 1] >= 0 else c
                  for c in pattern) for om in omega.tolist()))
    streams = [scan(rows, p) for p in insts]
    seen, data = set(), []
    for row in (r for s in streams for r in s):
        if row not in seen:
            seen.add(row)
            data.append(list(row))
    return data, sum(len(s) for s in streams)


def patterns(w):
    """Bound and unbound components, repeated variables, and constants
    from the store, absent inside a column's range, and below or above
    it."""
    rows, preds = w["rows"], w["preds"]
    lo_s = int(min(r[0] for r in rows))
    hi_o = int(max(r[2] for r in rows))
    absent = int(w["subjects"].max()) - 1
    picks = [rows[0], rows[len(rows) // 2], rows[-1]]
    out = set()
    for base in picks:
        for a in (base[0], absent, V(0), V(1)):
            for b in (base[1], int(preds.min()), V(1), V(2)):
                for c in (base[2], V(2), V(0)):
                    out.add((int(a), int(b), int(c)))
    if lo_s > 0:
        out.add((lo_s - 1, V(0), V(1)))
    out |= {(V(0), V(1), hi_o + 1),
            (V(0), int(preds.min()) - 1, V(1)),
            (V(0), int(preds.max()) + 1, V(1)),
            (V(0), V(1), (1 << 31) - 1), (0, V(0), V(1))}
    return sorted(p for p in out if max(p) < 1 << 31)


def omegas(w, rng, k=6):
    """Mappings of two variables from the store's ids, one unbound now
    and then, one repeated, and now and then an id outside a column's
    range or past its field."""
    pool = np.asarray([r[0] for r in w["rows"]] + [r[2] for r in w["rows"]])
    out = []
    for _ in range(k):
        om = rng.choice(pool, size=(int(rng.integers(1, 9)), 3))
        om[rng.random(om.shape) < 0.2] = -1
        om[-1] = om[0]
        if rng.random() < 0.4:
            om[0, 0] = rng.choice([int(w["preds"].min()) - 1,
                                   (1 << 31) - 1])
        out.append(om.astype(np.int32))
    return out


def backends(w):
    fed = FederatedStore.build(w["store"].triples, shards=4, device="cpu",
                               layout=w["store"].layout)
    return {
        "numpy": lambda tp, om: tcore.brtpf_select_with_cnt(
            w["store"], tp, om),
        "kernel": KernelSelector(w["store"], device="cpu").select_with_cnt,
        "sharded": ShardedSelector(fed, window=8).select_with_cnt,
    }


def test_layout_is_chosen_from_the_data(wide):
    lay = wide["store"].layout
    t = wide["store"].triples
    assert lay.offsets == tuple(int(x) for x in t.min(axis=0))
    assert lay.widths == tuple(int(h - lo).bit_length() for lo, h in
                               zip(t.min(axis=0), t.max(axis=0)))
    assert sum(lay.widths) <= 63
    if wide["name"] == "6000x":
        assert lay.widths == (25, 4, 25)
    for name, order in ORDERS.items():
        fields = lay.fields(name)
        assert [f[0] for f in fields] == list(order)
        assert [f[2] for f in fields] == [
            lay.widths[order[1]] + lay.widths[order[2]],
            lay.widths[order[2]], 0]
        keys = wide["store"]._indexes[name].keys
        assert (np.diff(keys) > 0).all()
        np.testing.assert_array_equal(lay.unpack(keys, name),
                                      t[wide["store"]._indexes[name].perm])


def test_store_pages_and_cnt_match_the_scan(wide):
    store, rows, ref = wide["store"], wide["rows"], wide["ref"]
    assert store.triples.tolist() == [list(r) for r in rows]
    for p in patterns(wide):
        tp = tcore.TriplePattern(*p)
        want = scan(rows, p)
        assert store.match(tp).tolist() == [list(r) for r in want], p
        assert ref.match(p).tolist() == [list(r) for r in want], p
        assert store.cardinality(tp) == len(want), p
        for off in (0, 3):
            page, total = store.match_range(tp, off, 3)
            assert page.tolist() == [list(r) for r in want[off:off + 3]]
            assert total == len(want)
    for r in rows[:5]:
        assert store.contains(np.asarray(r))


def test_fragments_match_the_scan_and_the_reference(wide):
    rng = np.random.default_rng(3)
    sel = backends(wide)
    rows, ref, preds = wide["rows"], wide["ref"], wide["preds"]
    cases = [(V(0), int(preds[0]), V(1)), (V(0), V(1), V(2)),
             (V(0), int(preds[1]), V(0)), (int(rows[-1][0]), V(1), V(2)),
             (V(2), V(1), V(0))]
    checked = 0
    for p in cases:
        for om in [None] + omegas(wide, rng):
            data, cnt = scan_fragment(rows, p, om)
            got, rcnt = reference.fragment(ref, p, om)
            assert got.tolist() == data and rcnt == cnt
            for name, select in sel.items():
                out, c = select(tcore.TriplePattern(*p), om)
                assert out.tolist() == data, (name, p)
                assert c == cnt, (name, p)
            checked += len(data)
    assert checked > 0


@pytest.mark.parametrize("backend", ["kernel", "sharded"])
def test_served_pages_and_solutions(wide, backend):
    """Pages through the server (page size 3) against the reference's,
    and BGP solutions of the port's brTPF client against the
    reference's and a scan that extends each solution by each match."""
    rows, ref, preds = wide["rows"], wide["ref"], wide["preds"]
    server = tcore.BrTPFServer(wide["store"], tcore.ServerConfig(
        selector_backend=backend, shards=4, shard_window=8, page_size=3,
        device="cpu"))
    rng = np.random.default_rng(5)
    for p in ((V(0), int(preds[0]), V(1)), (V(0), V(1), V(0))):
        for om in (None, omegas(wide, rng, 1)[0]):
            data, cnt = reference.fragment(ref, p, om)
            for k in range(len(data) // 3 + 2):
                frag = server.handle(tcore.Request(tcore.TriplePattern(*p),
                                                   om, page=k))
                want, wcnt, more = reference.page(data, cnt, k, 3)
                assert frag.data.tolist() == want.tolist()
                assert (frag.cnt, frag.has_next) == (wcnt, more)
    p0, p1, p2 = (int(x) for x in preds[:3])
    found = 0
    for bgp in ([(V(0), p0, V(1)), (V(1), p1, V(2))],
                [(V(0), p0, V(1)), (V(0), p1, V(2)), (V(0), p2, V(3))],
                [(V(0), p0, V(1)), (V(1), V(3), V(2))]):
        got = tcore.BrTPFClient(server).execute(tcore.bgp_from_arrays(bgp))
        sols = np.unique(got.solutions, axis=0)
        want = reference.solutions(ref, np.asarray(bgp, dtype=np.int64))
        assert sols.tolist() == want.tolist(), bgp
        found += want.shape[0]
    assert found > 0


def test_constants_outside_a_column_give_empty_pages(wide):
    store, lay = wide["store"], wide["store"].layout
    t = store.triples
    below = [int(x) - 1 for x in t.min(axis=0)]
    above = [int(lo) + (1 << w) for lo, w in zip(lay.offsets, lay.widths)]
    fed = FederatedStore.build(t, shards=4, device="cpu", layout=lay)
    sel = backends(wide)
    for col in range(3):
        for v in (below[col], above[col]):
            if v < 0:
                continue
            comps = [V(0), V(1), V(2)]
            comps[col] = v
            tp = tcore.TriplePattern(*comps)
            assert store.cardinality(tp) == 0
            assert len(store.candidate_range(tp)) == 0
            for name, select in sel.items():
                data, cnt = select(tp, None)
                assert data.shape == (0, 3) and cnt == 0, (name, col, v)
            for order in ORDERS:
                lo, hi = fed.prefix_keys(tp, order)
                if ORDERS[order][0] == col:
                    assert (lo, hi) == tstore.EMPTY_BOUNDS
            plan = fed.plan_windows(tp, [tp], 8)
            assert plan.pages == [] and plan.range_rows == 0
            row = np.asarray(t[0], dtype=np.int64)
            row[col] = v
            assert not store.contains(row)


def test_bounds_of_a_bound_prefix_bracket_exactly_its_rows(wide):
    store, lay = wide["store"], wide["store"].layout
    for name, order in ORDERS.items():
        keys = store._indexes[name].keys
        rows = store.triples[store._indexes[name].perm]
        for plen in (1, 2, 3):
            comps = rows[::7].astype(np.int64)
            lo, hi = lay.prefix_bounds(comps, name, plen)
            a = np.searchsorted(keys, lo, side="left")
            b = np.searchsorted(keys, hi, side="right")
            for i, row in enumerate(comps):
                same = np.ones(rows.shape[0], bool)
                for k in range(plen):
                    same &= rows[:, order[k]] == row[order[k]]
                idx = np.flatnonzero(same)
                assert (a[i], b[i]) == (idx[0], idx[-1] + 1)


@pytest.mark.parametrize("streams", ["one", "one index", "mixed"])
def test_stream_order_sorts_each_stream_by_its_index(wide, streams):
    """``stream_order`` against a sort written here: the streams in
    turn, each stream's rows ascending under its own pattern's index,
    whether every stream keys by one index or not, and whatever streams
    the kept rows leave out."""
    from repro_torch.core.kernel_selectors import stream_order
    rng = np.random.default_rng(7)
    lay, rows = wide["store"].layout, wide["store"].triples
    s, p, o = (int(x) for x in rows[len(rows) // 2])
    insts = [tcore.TriplePattern(*c) for c in ((V(0), p, o), (V(0), p, V(1)),
                                               (s, V(0), V(1)),
                                               (V(0), V(1), o))]
    if streams != "mixed":
        insts = [tcore.TriplePattern(V(0), p, int(x)) for x in rows[:6, 2]]
    k = 1 if streams == "one" else len(insts)
    for n in (0, 1, 7, 90):
        kept = rows[rng.choice(len(rows), n)]
        first = rng.integers(k - 1 if k == 1 else 1, k, n)
        want = []
        for j in sorted(set(first.tolist())):
            name, _ = tcore.TripleStore._choose_index(insts[j])
            want += sorted(kept[first == j].tolist(),
                           key=lambda r: [r[c] for c in ORDERS[name]])
        got = stream_order(kept, first, insts, lay)
        assert got.dtype == np.int32 and got.tolist() == want, n


def test_columns_past_63_bits_raise():
    top = (1 << 31) - 1
    t = np.asarray([[0, 0, 0], [top, 3, top]], dtype=np.int32)
    with pytest.raises(ValueError, match=r"\(31, 2, 31\) bits"):
        tcore.TripleStore(t)
    # 31 + 1 + 31 bits fit
    assert tcore.TripleStore(t[:, :] // [1, 2, 1]).layout.widths == \
        (31, 1, 31)


def test_build_record_holds_every_phase():
    triples, _, _ = _triples("6000x")
    store = tcore.TripleStore(triples)
    assert set(metrics.STORE_BUILD.host) == {"dedup", "pos", "osp"}
    assert metrics.STORE_BUILD.device == {}
    assert metrics.STORE_BUILD.widths == {
        "spo": (25, 4, 25), "pos": (4, 25, 25), "osp": (25, 25, 4)}
    FederatedStore.build(store.triples, shards=4, device="cpu",
                         layout=store.layout)
    assert set(metrics.STORE_BUILD.device) == {"spo", "pos", "osp", "copy"}
    assert all(v >= 0 for v in metrics.STORE_BUILD.host.values())
    assert all(v >= 0 for v in metrics.STORE_BUILD.device.values())


@pytest.mark.parametrize("order", list(ORDERS))
def test_narrow_keys_are_the_jax_packages(order):
    from repro.core.store import _MAX_ID, _pack
    rng = np.random.default_rng(11)
    t = rng.integers(0, 1 << 21, size=(400, 3)).astype(np.int32)
    t[0] = (1 << 21) - 1
    store = tcore.TripleStore(t)
    lay = store.layout
    assert lay == tstore.KeyLayout.narrow()
    comp = ORDERS[order]
    rows = store.triples
    want = np.asarray(_pack(rows[:, comp[0]], rows[:, comp[1]],
                            rows[:, comp[2]]))
    np.testing.assert_array_equal(lay.pack(rows, order), want)
    np.testing.assert_array_equal(store._indexes[order].keys, np.sort(want))
    for plen in range(4):
        vals = [rows[:, comp[i]].astype(np.int64) if i < plen else None
                for i in range(3)]
        lo = [v if v is not None else np.zeros(len(rows), np.int64)
              for v in vals]
        hi = [v if v is not None else np.full(len(rows), _MAX_ID, np.int64)
              for v in vals]
        got = lay.prefix_bounds(rows.astype(np.int64), order, plen)
        np.testing.assert_array_equal(got[0], np.asarray(_pack(*lo)))
        np.testing.assert_array_equal(got[1], np.asarray(_pack(*hi)))
