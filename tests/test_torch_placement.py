"""The port's placement planner against the JAX package's, exactly.

``repro_torch.core.placement`` is a numpy copy of
``repro.core.placement``; these tests feed both the same heat records and
key arrays and require identical boundaries, weights and replica ranges,
and the same ``shard_balance`` / ``rebalance_report`` schema. The
configuration checks of the sharded backend's ``ServerConfig`` fields
are held against the reference's too.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.core.metrics as jmetrics
import repro.core.placement as jplace
import repro_torch.core as tcore
import repro_torch.core.metrics as tmetrics
import repro_torch.core.placement as tplace

pytestmark = pytest.mark.tier1


def store_array(seed=0, n=2000, terms=40):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, terms, size=(n, 3)).astype(np.int32),
                     axis=0)


def heat_records(seed, keys_by_order, n=60, skew=2.0):
    """Zipf-skewed (order, lo, hi, launches, rows, pages) records over
    sub-ranges of each order's sorted keys."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        order = ("spo", "pos", "osp")[int(rng.integers(0, 3))]
        keys = keys_by_order[order]
        rank = min(int(rng.zipf(skew)), 50)
        lo = int(keys[(rank * 37) % (keys.size - 8)])
        hi = int(keys[min(keys.size - 1, (rank * 37) % (keys.size - 8)
                          + int(rng.integers(0, 8)))])
        out.append((order, lo, hi, int(rng.integers(1, 9)),
                    int(rng.integers(0, 500)), int(rng.integers(0, 9))))
    return out


def both_logs(records, capacity=4096):
    jlog, tlog = jplace.HeatLog(capacity), tplace.HeatLog(capacity)
    for rec in records:
        jlog.record(*rec)
        tlog.record(*rec)
    return jlog, tlog


def placement_tuple(placement):
    return ({k: np.asarray(v).tolist()
             for k, v in placement.boundaries.items()},
            {k: [dataclasses.astuple(r) for r in v]
             for k, v in placement.replicas.items()},
            placement.has_replicas)


def test_dataset_keys():
    arr = store_array(1)
    jk, tk = jplace.dataset_keys(arr), tplace.dataset_keys(arr)
    assert jk.keys() == tk.keys()
    for name in jk:
        np.testing.assert_array_equal(tk[name], jk[name])


@pytest.mark.parametrize("capacity", [4096, 16])
def test_heat_log(capacity):
    arr = store_array(2)
    recs = heat_records(2, jplace.dataset_keys(arr))
    jlog, tlog = both_logs(recs, capacity)
    assert len(tlog) == len(jlog)
    assert tlog.total_launches == jlog.total_launches
    for order in (None, "spo", "pos", "osp"):
        assert [dataclasses.astuple(r) for r in tlog.records(order)] \
            == [dataclasses.astuple(r) for r in jlog.records(order)]
    with pytest.raises(ValueError):
        tplace.HeatLog(0)


@pytest.mark.parametrize("shards", [1, 2, 4, 7])
def test_boundaries_and_weights(shards):
    arr = store_array(3)
    keys = jplace.dataset_keys(arr)["spo"]
    recs = heat_records(3, jplace.dataset_keys(arr))
    jlog, tlog = both_logs(recs)
    jw = jplace.heat_weights(keys, jlog.records("spo"), base=0.25)
    tw = tplace.heat_weights(keys, tlog.records("spo"), base=0.25)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(
        tplace.weighted_boundaries(keys, tw, shards),
        jplace.weighted_boundaries(keys, jw, shards))
    np.testing.assert_array_equal(tplace.equal_boundaries(keys, shards),
                                  jplace.equal_boundaries(keys, shards))


@pytest.mark.parametrize("seed,shards,max_replicas",
                         [(4, 4, 1), (5, 4, 2), (6, 3, 1), (7, 1, 1)])
def test_plan_placement(seed, shards, max_replicas):
    arr = store_array(seed)
    kj = jplace.dataset_keys(arr)
    kt = tplace.dataset_keys(arr)
    jlog, tlog = both_logs(heat_records(seed, kj, skew=1.6))
    want = jplace.plan_placement(jlog, kj, shards,
                                 max_replicas=max_replicas)
    got = tplace.plan_placement(tlog, kt, shards, max_replicas=max_replicas)
    assert placement_tuple(got) == placement_tuple(want)
    for name, bounds in got.boundaries.items():
        if len(bounds):
            np.testing.assert_array_equal(
                got.shard_of(name, kt[name]), want.shard_of(name, kj[name]))
    # a single-key hot spot cannot be split: it is replicated
    hot = int(kj["spo"][10])
    jhot, thot = both_logs([("spo", hot, hot, 500, 0, 0)])
    want = jplace.plan_placement(jhot, kj, 4)
    got = tplace.plan_placement(thot, kt, 4)
    assert placement_tuple(got) == placement_tuple(want)
    assert got.has_replicas


def test_shard_balance_and_rebalance_report():
    for args in [([9, 1, 1, 1], [90, 10, 10, 10], [9, 1, 1, 1]),
                 ([0, 0], [0, 0], [0, 0]), ([3], [30], [4])]:
        assert tmetrics.shard_balance(*args) == jmetrics.shard_balance(*args)
    uniform = jmetrics.shard_balance([8, 0, 0, 0], [0] * 4, [0] * 4)
    heat = jmetrics.shard_balance([2, 2, 2, 2], [0] * 4, [0] * 4)
    assert tmetrics.rebalance_report(uniform, heat) \
        == jmetrics.rebalance_report(uniform, heat)


@pytest.mark.parametrize("changes,error", [
    (dict(placement_policy="zipf"), ValueError),
    (dict(heat_capacity=0), ValueError),
    (dict(shards=0), None),
    (dict(shard_window=256, placement_policy="heat", heat_capacity=8),
     None)])
def test_sharded_config_fields(changes, error):
    """The sharded fields keep the reference's defaults and checks; the
    port's ``shards`` replaces the mesh and has its own check."""
    tfields = {f.name: f.default for f in dataclasses.fields(
        tcore.ServerConfig)}
    jfields = {f.name: f.default for f in dataclasses.fields(
        jcore.ServerConfig)}
    for name in ("shard_window", "placement_policy", "heat_capacity"):
        assert tfields[name] == jfields[name]
    assert "shard_axis" not in tfields and tfields["shards"] == 1
    if "shards" in changes:
        with pytest.raises(ValueError, match="shards"):
            tcore.ServerConfig(selector_backend="sharded", **changes)
    elif error is not None:
        with pytest.raises(error):
            jcore.ServerConfig(selector_backend="sharded", **changes)
        with pytest.raises(error):
            tcore.ServerConfig(selector_backend="sharded", **changes)
    else:
        cfg = tcore.ServerConfig(selector_backend="sharded", **changes)
        ref = jcore.ServerConfig(selector_backend="sharded", **changes)
        for name, value in changes.items():
            assert getattr(cfg, name) == getattr(ref, name) == value
