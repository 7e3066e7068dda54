"""The hand-written CUDA kernels against their plain PyTorch versions.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels build from
``src/repro_torch/kernels/csrc`` at first use); elsewhere they skip.
Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. Outputs are integers: equality is exact.
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels.tpf_match import tpf_match_cuda, tpf_match_plain

# the package re-exports the bindjoin op under the module's name
tbindjoin = importlib.import_module("repro_torch.kernels.bindjoin")


def rand_triples(rng, t, terms=6):
    return rng.integers(0, terms, size=(t, 3)).astype(np.int32)


def rand_patterns(rng, shape, terms=6, wild_frac=0.4):
    pats = rng.integers(0, terms, size=(*shape, 3)).astype(np.int32)
    pats[rng.random((*shape, 3)) < wild_frac] = -1
    return pats


def live_prefix_slots(rng, g, mp, live):
    """A slot table as marshal_pattern_grid makes one: per group a live
    prefix of random slots (the last one valid, a hole below it), then
    padding; returns it with its live width."""
    slots = np.zeros((g, mp, 4), np.int32)
    slots[:, :live, :3] = rand_patterns(rng, (g, live), terms=4)
    slots[:, :live, 3] = 1
    if live > 2:
        slots[:, live // 2, 3] = 0
    return slots, live


def assert_windows_equal(got, want):
    """mask and cnt exactly; first wherever the mask is set (the kernel
    leaves the other entries unset)."""
    mask, first, cnt, _ = got
    assert torch.equal(mask, want[0]) and torch.equal(cnt, want[2])
    kept = mask.bool()
    assert torch.equal(first[kept], want[1][kept])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each hand-written kernel against its plain version on the card."""

    @pytest.mark.parametrize("t", [1, 70001])
    def test_tpf_match(self, cuda_device, t):
        """The [T, 3] rows as they lie, a ragged T, a uint8 mask."""
        rng = np.random.default_rng(31)
        cand = torch.as_tensor(rand_triples(rng, t, terms=3),
                               device=cuda_device)
        for vec in [(-1, -1, -1, 0, 0, 0), (1, -1, -1, 0, 1, 0),
                    (-1, 2, -1, 0, 0, 0), (-1, -1, -1, 1, 1, 1)]:
            pv = torch.tensor([*vec, 0, 0], dtype=torch.int32,
                              device=cuda_device)
            got = tpf_match_cuda(cand, pv)
            want = tpf_match_plain(cand, pv)
            torch.cuda.synchronize()
            assert got.dtype == torch.uint8 and torch.equal(got, want)

    @pytest.mark.parametrize("t,g,mp", [(1000, 1, 128), (4096, 3, 256),
                                        (300, 8, 384)])
    def test_bindjoin_grouped(self, cuda_device, t, g, mp):
        """The reference op's contract: prologue off, dense outputs."""
        rng = np.random.default_rng(t + g + mp)
        cand = torch.as_tensor(rand_triples(rng, t), device=cuda_device)
        slots = rand_patterns(rng, (g, mp))
        slots = np.concatenate(
            [slots, (rng.random((g, mp, 1)) < 0.7).astype(np.int32)], -1)
        args = (cand[None], None, torch.as_tensor(slots, device=cuda_device),
                torch.tensor([-1, -1, -1, 0, 0, 0, 0, 0], dtype=torch.int32,
                             device=cuda_device))
        kw = dict(spans=torch.tensor([[[0, t]]], device=cuda_device),
                  width=t, live=mp, dense=True)
        got = tbindjoin.bindjoin_grouped_cuda(*args, **kw)
        want = tbindjoin.bindjoin_grouped_plain(*args, **kw)
        torch.cuda.synchronize()
        for w, o in zip(want, got, strict=True):
            assert torch.equal(w, o)

    @pytest.mark.parametrize("live", [1, 30])
    @pytest.mark.parametrize("g", [1, 8])
    @pytest.mark.parametrize("s", [1, 4])
    @pytest.mark.parametrize("p", [1, 7])
    @pytest.mark.parametrize("mode", ["spans", "rows"])
    def test_bindjoin_windows(self, cuda_device, mode, p, s, g, live):
        """The windowed grouped kernel at the main path's geometry: P
        pages of S shards of W = 1024 rows, G groups of live slots out of
        Mp = 128 (a live prefix with a hole, then padding, as
        marshal_pattern_grid makes them), a base pattern with a bound
        component and a repeated variable."""
        rng = np.random.default_rng(p * 1000 + s * 100 + g * 10 + live)
        w, n, mp = 1024, 3000, 128
        dev = cuda_device
        triples = torch.as_tensor(
            rand_triples(rng, s * n, terms=4).reshape(s, n, 3), device=dev)
        valid = torch.as_tensor(rng.random((s, n)) < 0.9, device=dev)
        slots, _ = live_prefix_slots(rng, g, mp, live)
        # instantiations carry the base pattern's bound predicate; the
        # last live slot matches every row that passes the prologue, so
        # a live bound one short would lose rows
        slots[:, :live, 1] = np.where(slots[:, :live, 1] < 0, -1, 3)
        slots[:, live - 1, :3] = (-1, 3, -1)
        slots = torch.as_tensor(slots, device=dev)
        base = torch.tensor([-1, 3, -1, 0, 1, 0, 0, 0], dtype=torch.int32,
                            device=dev)
        where = {}
        if mode == "spans":
            lo = rng.integers(0, n, size=(p, s))
            hi = np.minimum(lo + w, rng.integers(lo, n + 1))
            where["spans"] = torch.as_tensor(
                np.stack([lo, hi], -1).astype(np.int64), device=dev)
        else:
            rows = np.full((p, s, w), -1, np.int32)
            for i in range(p):
                for j in range(s):
                    k = int(rng.integers(0, w + 1))
                    rows[i, j, :k] = np.sort(rng.choice(n, k, False))
            where["rows"] = torch.as_tensor(rows, device=dev)
        args = (triples, valid, slots, base)
        got = tbindjoin.bindjoin_grouped_cuda(*args, width=w, live=live,
                                              **where)
        again = tbindjoin.bindjoin_grouped_cuda(*args, width=w, live=live,
                                                **where)
        want = tbindjoin.bindjoin_grouped_plain(*args, width=w, live=live,
                                                **where)
        torch.cuda.synchronize()
        assert_windows_equal(got, want)
        # cnt's per-warp atomics land in any order: integer sums agree
        assert torch.equal(again[2], got[2])
        assert bool(got[0].any())

    def test_bindjoin_windows_int64_positions(self, cuda_device):
        """Spans far past 2^31 are positions, not wrapped int32: they lie
        past the shard's end and keep nothing, on the card as on the
        plain version."""
        rng = np.random.default_rng(5)
        dev = cuda_device
        triples = torch.as_tensor(rand_triples(rng, 2 * 512).reshape(
            2, 512, 3), device=dev)
        slots, live = live_prefix_slots(rng, 2, 128, 4)
        spans = torch.tensor([[[0, 512], [(1 << 32) + 3, (1 << 32) + 600]],
                              [[(1 << 31) - 10, 1 << 33], [100, 400]]],
                             dtype=torch.int64, device=dev)
        args = (triples, None, torch.as_tensor(slots, device=dev),
                torch.tensor([-1, -1, -1, 0, 0, 0, 0, 0], dtype=torch.int32,
                             device=dev))
        got = tbindjoin.bindjoin_grouped_cuda(*args, spans=spans, width=600,
                                              live=live)
        want = tbindjoin.bindjoin_grouped_plain(*args, spans=spans,
                                                width=600, live=live)
        torch.cuda.synchronize()
        assert_windows_equal(got, want)
        assert not got[0][0, 1].any() and not got[0][1, 0].any()

    # (pages, shards, width, segments, groups, Mp, live, dead pages,
    # dense, seg_of_page layout)
    FUSED_CASES = {
        # dead pages among three segments, mask and first where kept
        "dead": (6, 2, 1024, 3, 2, 128, 30, 2, False, "random"),
        # the same, every output written for every row
        "dead_dense": (6, 2, 1024, 3, 2, 128, 30, 2, True, "random"),
        # 4096 one-tile pages of alternating segments: a block's run of
        # items crosses segments and restages its table
        "alternating": (4096, 1, 256, 2, 1, 128, 30, 0, False, "alternate"),
        # a segment's table of 4 x 1024 live slots (64 KiB) is staged a
        # group range at a time
        "group_ranges": (5, 2, 512, 2, 4, 1024, 1024, 1, False, "random"),
        # one group of 4096 live slots (64 KiB) is staged a slot range at
        # a time
        "slot_ranges": (5, 2, 512, 2, 1, 4096, 4096, 1, True, "random"),
    }

    @pytest.mark.parametrize("case", sorted(FUSED_CASES))
    def test_bindjoin_fused(self, cuda_device, case):
        """The fused kernel against its plain version: P pages of S
        shards, each page against its own segment's slot table (a live
        prefix with a hole, then padding) and base pattern (the first
        segment a wildcard, the others a bound predicate and a repeated
        variable)."""
        p, s, w, segs, g, mp, live, dead, dense, layout = \
            self.FUSED_CASES[case]
        rng = np.random.default_rng(sum(map(ord, case)))
        dev = cuda_device
        n = 3000
        triples = torch.as_tensor(
            rand_triples(rng, s * n, terms=4).reshape(s, n, 3), device=dev)
        valid = torch.as_tensor(rng.random((s, n)) < 0.9, device=dev)
        slots = np.stack([live_prefix_slots(rng, g, mp, live)[0]
                          for _ in range(segs)])
        slots[:, :, live - 1, :3] = -1   # keeps every row that passes
        base = np.tile(np.array([-1, 3, -1, 0, 1, 0, 0, 0], np.int32),
                       (segs, 1))
        base[0] = [-1, -1, -1, 0, 0, 0, 0, 0]
        if layout == "alternate":
            seg = np.arange(p) % segs
        else:
            seg = rng.integers(0, segs, size=p)
        seg[rng.permutation(p)[:dead]] = -1
        lo = rng.integers(0, n, size=(p, s))
        hi = np.minimum(lo + w, rng.integers(lo, n + 1))
        args = (triples, valid, torch.as_tensor(slots, device=dev),
                torch.as_tensor(base, device=dev))
        kw = dict(spans=torch.as_tensor(np.stack([lo, hi], -1),
                                        device=dev),
                  seg_of_page=torch.as_tensor(seg.astype(np.int32),
                                              device=dev),
                  width=w, live=live, dense=dense)
        got = tbindjoin.bindjoin_fused_cuda(*args, **kw)
        again = tbindjoin.bindjoin_fused_cuda(*args, **kw)
        want = tbindjoin.bindjoin_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        if dense:
            for wt, o in zip(want, got, strict=True):
                assert torch.equal(wt, o)
        else:
            assert_windows_equal(got, want)
        assert torch.equal(again[2], got[2])
        assert bool(got[0].any())
        if dead:
            assert not got[0][torch.as_tensor(seg < 0, device=dev)].any()

    def test_bindjoin_fused_int64_positions(self, cuda_device):
        """Spans past a shard's end and past 2^32 keep nothing, on the
        card as on the plain version, on pages of two segments."""
        rng = np.random.default_rng(6)
        dev = cuda_device
        triples = torch.as_tensor(rand_triples(rng, 2 * 512).reshape(
            2, 512, 3), device=dev)
        slots = np.stack([live_prefix_slots(rng, 2, 128, 4)[0]
                          for _ in range(2)])
        spans = torch.tensor([[[0, 512], [(1 << 32) + 3, (1 << 32) + 600]],
                              [[(1 << 31) - 10, 1 << 33], [100, 400]],
                              [[400, 1000], [0, 600]]],
                             dtype=torch.int64, device=dev)
        args = (triples, None, torch.as_tensor(slots, device=dev),
                torch.tensor([[-1, -1, -1, 0, 0, 0, 0, 0]] * 2,
                             dtype=torch.int32, device=dev))
        kw = dict(spans=spans, width=600, live=4,
                  seg_of_page=torch.tensor([1, 0, 1], dtype=torch.int32,
                                           device=dev))
        got = tbindjoin.bindjoin_fused_cuda(*args, **kw)
        want = tbindjoin.bindjoin_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        assert_windows_equal(got, want)
        assert not got[0][0, 1].any() and not got[0][1, 0].any()

    @pytest.mark.parametrize("tiles,segs,g,m,dead", [(12, 4, 2, 384, 3),
                                                     (512, 16, 2, 1000, 40)])
    def test_ops_bindjoin_fused(self, cuda_device, tiles, segs, g, m, dead):
        """The reference op's contract (one page per 256-row tile,
        wildcard base vectors, dense outputs) on the card against the
        same op on the CPU, the plain version."""
        rng = np.random.default_rng(tiles + m)
        cand = rand_triples(rng, tiles * 256)
        seg = rng.integers(0, segs, size=tiles).astype(np.int32)
        seg[rng.permutation(tiles)[:dead]] = -1
        pats = rand_patterns(rng, (segs, g, m))
        valid = (rng.random((segs, g, m)) < 0.7).astype(np.int32)
        inputs = [torch.as_tensor(x) for x in (cand, seg, pats, valid)]
        got = tops.bindjoin_fused(*(x.to(cuda_device) for x in inputs))
        want = tops.bindjoin_fused(*inputs)
        torch.cuda.synchronize()
        for wt, o in zip(want, got, strict=True):
            assert torch.equal(wt, o.cpu())
        assert bool(got[0].any())

    @pytest.mark.parametrize("t", [1, 1023, 4096, 1 << 20])
    @pytest.mark.parametrize("m", [128, 256])
    def test_bindjoin(self, cuda_device, t, m):
        rng = np.random.default_rng(t + m)
        triples = rand_triples(rng, t)
        pats = rand_patterns(rng, (m,))
        # every slot binds its subject, and every 4th row's subject is in
        # no slot: those rows match nothing (idx == m)
        pats[:, 0] = rng.integers(0, 6, size=m)
        triples[::4, 0] = 7
        cand = [torch.as_tensor(c, device=cuda_device)
                for c in triples.T.copy()]
        flat = [torch.as_tensor(c, device=cuda_device)
                for c in pats.T.copy()]
        pv = torch.as_tensor((rng.random(m) < 0.3).astype(np.int32),
                             device=cuda_device)
        got = tbindjoin.bindjoin_cuda(*cand, *flat, pv)
        want = tbindjoin.bindjoin_plain(*cand, *flat, pv)
        torch.cuda.synchronize()
        for w, o in zip(want, got, strict=True):
            assert torch.equal(w, o)
        assert bool((got[1] == m).any())
        if t > 1:
            assert bool((got[0] == 1).any())


@pytest.mark.cuda
def test_sharded_selector_on_card_equals_cpu(cuda_device):
    """Four logical shards on the card against the same on the CPU:
    fragments, cnt, LaunchRecords and per-shard counters."""
    import dataclasses

    from repro_torch.core import TriplePattern, encode_var
    from repro_torch.core.federation import FederatedStore, ShardedSelector
    from repro_torch.core.kernel_selectors import FusedSegment

    v = encode_var
    rng = np.random.default_rng(7)
    arr = np.unique(rng.integers(0, 15, size=(900, 3)).astype(np.int32),
                    axis=0)
    om = rng.integers(0, 15, size=(6, 2)).astype(np.int32)

    def run(device):
        sel = ShardedSelector(FederatedStore.build(arr, 4, device=device),
                              window=32)
        out = [sel.select_with_cnt(TriplePattern(v(0), 3, v(1)), o)
               for o in (None, om)]
        out += sel.select_same_pattern(TriplePattern(v(0), v(1), v(2)),
                                       [None, om[:, :1]])
        out.append((np.empty((0, 3), np.int32), sel.select_count(
            TriplePattern(v(0), 2, v(0)), None)))
        out += [r for row in sel.select_fused([
            FusedSegment(TriplePattern(v(0), 4, v(1)), [om]),
            FusedSegment(TriplePattern(v(0), 5, v(1)), [None])])
            for r in row]
        full = sel.fed.execute_full(TriplePattern(v(0), 3, v(1)), om, 30,
                                    256)
        return ([(d.tobytes(), d.shape, c) for d, c in out],
                [dataclasses.asdict(r) for r in sel.launches],
                sel.shard_balance(), full.tobytes())

    assert run(cuda_device) == run("cpu")



@pytest.mark.cuda
def test_routed_replica_placement_on_card_equals_cpu(cuda_device):
    """Four logical shards under a manual placement with a replica range
    (the routed step: replica spans subtracted from non-owners, each
    replicated span served by its least-loaded holder), on the card
    against the same on the CPU: fragments, LaunchRecords, per-shard
    pages and balance."""
    import dataclasses

    from repro_torch import core
    from repro_torch.core.federation import FederatedStore
    from repro_torch.core.placement import (Placement, ReplicaRange,
                                            dataset_keys)

    v = core.encode_var
    n_subj, per_subj = 64, 8
    s = np.repeat(np.arange(n_subj), per_subj) + 100
    p = np.tile(np.arange(per_subj), n_subj) % 4 + 1
    o = np.arange(s.size) + 10_000
    store = core.TripleStore(np.stack([s, p, o], axis=1).astype(np.int32))
    keys = dataset_keys(store.triples)["spo"]
    n = keys.size
    manual = Placement(
        boundaries={"spo": np.array([keys[n // 2], keys[5 * n // 8],
                                     keys[6 * n // 8]], dtype=np.int64)},
        replicas={"spo": (ReplicaRange(
            "spo", int(keys[10 * per_subj]), int(keys[12 * per_subj - 1]),
            home=0, replicas=(2,)),)})
    om = np.array([[2, -1], [3, -1]], np.int32)
    hot = [core.Request(core.TriplePattern(100 + subj, v(0), v(1)),
                        np.roll(om, k, axis=0), page=0)
           for subj in (10, 11) for k in (0, 1)]
    cold = [core.Request(core.TriplePattern(100 + subj, v(0), v(1)), om, 0)
            for subj in (5, 40, 60)]
    wide = [core.Request(core.TriplePattern(v(0), 2, v(1)), None, pg)
            for pg in range(3)]
    batch = [core.Request(core.TriplePattern(110, v(0), v(1)), om[:1], 0),
             core.Request(core.TriplePattern(v(0), 3, v(1)), None, 0),
             core.Request(core.TriplePattern(111, v(0), v(1)), om, 0)]

    def run(device):
        srv = core.BrTPFServer(store, core.ServerConfig(
            selector_backend="sharded", shards=4, shard_window=16,
            device=device))
        placed = FederatedStore.build(store.triples, 4, device=device,
                                      placement=manual)
        srv.federated = placed
        srv._selector.rebind(placed)
        srv.fragments.clear()
        frags = [srv.handle(r) for r in hot * 3 + cold + wide]
        frags += srv.handle_batch(batch)
        return ([(f.data.tobytes(), f.data.shape, f.cnt, f.has_next)
                 for f in frags],
                [dataclasses.asdict(r) for r in srv._selector.launches],
                srv.shard_launch_snapshot().tolist(),
                srv.metrics_snapshot()["shards"])

    got = run(cuda_device)
    assert got == run("cpu")
    # the replicated block was charged to both of its holders {0, 2}
    assert got[2][0] > 0 and got[2][2] > 0


@pytest.mark.cuda
def test_sharded_request_one_launch_per_chunk(cuda_device, monkeypatch):
    """A request of many window pages over four shards: one grouped CUDA
    launch per chunk (the cap forced to three pages), no tpf_match
    launch, and fragments, cnt and LaunchRecords equal to the CPU run's."""
    import dataclasses

    from repro_torch.core import TriplePattern, encode_var
    from repro_torch.core import federation
    from repro_torch.kernels.tpf_match import tpf_match_cuda

    v = encode_var
    rng = np.random.default_rng(9)
    arr = np.unique(rng.integers(0, 15, size=(3000, 3)).astype(np.int32),
                    axis=0)
    om = rng.integers(0, 15, size=(5, 2)).astype(np.int32)
    monkeypatch.setattr(federation, "MAX_CHUNK_ROWS", 3 * 4 * 16)

    def run(device):
        sel = federation.ShardedSelector(
            federation.FederatedStore.build(arr, 4, device=device),
            window=16)
        out = [sel.select_with_cnt(TriplePattern(v(0), v(1), v(2)), None)]
        out += sel.select_same_pattern(TriplePattern(v(0), 3, v(1)),
                                       [None, om])
        return ([(d.tobytes(), d.shape, c) for d, c in out],
                [dataclasses.asdict(r) for r in sel.launches],
                sel.grouped_chunks)

    grouped = tbindjoin.bindjoin_grouped_cuda
    before = (grouped.launches, tpf_match_cuda.launches)
    got = run(cuda_device)
    launched = (grouped.launches - before[0],
                tpf_match_cuda.launches - before[1])
    want = run("cpu")
    assert got == want
    pages = len(got[1])
    assert launched == (got[2], 0)
    assert got[2] == sum(-(-len(r) // 3) for r in (
        [x for x in got[1] if x["groups"] == 1],
        [x for x in got[1] if x["groups"] == 2]))
    assert pages > got[2] > 2


@pytest.mark.cuda
def test_sharded_fused_one_launch_per_chunk(cuda_device, monkeypatch):
    """A heterogeneous batch of one index order over four shards: one
    fused CUDA launch per chunk of its rounds' pages (the cap forced to
    three pages), and fragments, cnt, LaunchRecords and per-shard
    counters equal to the CPU run's."""
    import dataclasses

    from repro_torch.core import TriplePattern, encode_var
    from repro_torch.core import federation
    from repro_torch.core.kernel_selectors import FusedSegment

    v = encode_var
    rng = np.random.default_rng(10)
    arr = np.unique(rng.integers(0, 15, size=(3000, 3)).astype(np.int32),
                    axis=0)
    om = rng.integers(0, 15, size=(5, 2)).astype(np.int32)
    monkeypatch.setattr(federation, "MAX_CHUNK_ROWS", 3 * 4 * 16)

    def run(device):
        sel = federation.ShardedSelector(
            federation.FederatedStore.build(arr, 4, device=device),
            window=16)
        rows = sel.select_fused([
            FusedSegment(TriplePattern(v(0), 3, v(1)), [None, om]),
            FusedSegment(TriplePattern(v(0), 5, v(1)), [om]),
            FusedSegment(TriplePattern(v(0), 7, v(1)), [None],
                         count_only=True)])
        return ([(d.tobytes(), d.shape, c) for row in rows for d, c in row],
                [dataclasses.asdict(r) for r in sel.launches],
                sel.shard_balance(), sel.fused_chunks)

    fused = tbindjoin.bindjoin_fused_cuda
    before = fused.launches
    got = run(cuda_device)
    launched = fused.launches - before
    assert got == run("cpu")
    rounds = [r for r in got[1] if r["segments"] >= 2]
    assert launched == got[3] and got[3] > 1 and len(rounds) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["kernel", "sharded"])
def test_sim_traces_count_the_cuda_launches(cuda_device, monkeypatch,
                                             backend):
    """``collect_traces`` on the card, on the kernel backend and on the
    sharded backend (four shards, 16-row windows, the chunk cap forced to
    three pages): the traces' CUDA launches equal the bind-join wrappers'
    launches, and every record equals the CPU run's."""
    import dataclasses

    from repro_torch.core import BrTPFServer, ServerConfig, federation, sim
    from repro_torch.data import watdiv

    data = watdiv.generate(watdiv.WatDivScale(
        users=120, products=60, reviews=180, retailers=6, genres=8,
        cities=10, tags=12), seed=3)
    queries = watdiv.generate_workload(data, 4, seed=1)[:3]
    monkeypatch.setattr(federation, "MAX_CHUNK_ROWS", 3 * 4 * 16)
    cfg = ServerConfig(selector_backend=backend, shards=4, shard_window=16,
                       fast_path_rows=0)

    def run(device):
        traces = sim.collect_traces(
            BrTPFServer(data.store, cfg.replace(device=device)), queries,
            "brtpf", request_budget=40)
        return [dataclasses.asdict(ev) for t in traces for ev in t.events
                if isinstance(ev, sim.HttpRecord)]

    wrappers = (tbindjoin.bindjoin_grouped_cuda,
                tbindjoin.bindjoin_fused_cuda, tbindjoin.bindjoin_cuda,
                tpf_match_cuda)
    before = [w.launches for w in wrappers]
    got = run(cuda_device)
    launched = [w.launches - b for w, b in zip(wrappers, before,
                                                strict=True)]
    assert got == run("cpu")
    cuda_launches = sum(r["cuda_launches"] for r in got)
    assert cuda_launches == sum(launched) == launched[0] > 0
    assert sum(r["launches"] for r in got) >= cuda_launches


@pytest.mark.cuda
def test_sharded_store_past_24_bit_ids_on_card_equals_cpu(cuda_device):
    """Term ids past 2**24 (each column keyed by its own range): four
    logical shards on the card serve the pages, cnt and has_next of the
    same store on the CPU, single requests and a heterogeneous batch,
    bound constants outside a column's range included."""
    from repro_torch import core
    from repro_torch.core.store import KeyLayout

    v = core.encode_var
    rng = np.random.default_rng(24)
    base = (1 << 24) + 12_345
    ents = base + rng.choice(1 << 22, 600, replace=False)
    preds = (1 << 25) + np.arange(6)
    arr = np.stack([rng.choice(ents, 6000), rng.choice(preds, 6000),
                    rng.choice(ents, 6000)], axis=1).astype(np.int32)
    store = core.TripleStore(arr)
    assert store.layout != KeyLayout.narrow()
    om = np.stack([rng.choice(ents, 8), rng.choice(ents, 8)],
                  axis=1).astype(np.int32)
    om[0, 0] = int(preds[0])                  # outside the subjects
    reqs = [core.Request(core.TriplePattern(v(0), int(p), v(1)), w, pg)
            for p in preds[:3] for w in (None, om) for pg in (0, 2)]
    reqs += [core.Request(core.TriplePattern(int(ents[0]), v(0), v(1))),
             core.Request(core.TriplePattern(v(0), int(preds[0]) - 1,
                                             v(1))),
             core.Request(core.TriplePattern(v(0), v(1), (1 << 31) - 1)),
             core.Request(core.TriplePattern(v(0), v(1), v(2)), None, 5,
                          count_only=True)]
    batch = [core.Request(core.TriplePattern(v(0), int(p), v(1)), om[:k])
             for k, p in enumerate(preds, start=1)]

    def run(device):
        srv = core.BrTPFServer(store, core.ServerConfig(
            selector_backend="sharded", shards=4, shard_window=64,
            device=device))
        assert srv.federated.layout == store.layout
        frags = [srv.handle(r) for r in reqs] + srv.handle_batch(batch)
        return [(f.data.tobytes(), f.data.shape, f.cnt, f.has_next)
                for f in frags]

    got = run(cuda_device)
    assert got == run("cpu")
    assert sum(shape[0] for _, shape, _, _ in got) > 100
    assert got[len(reqs) - 3][2] == got[len(reqs) - 2][2] == 0


@pytest.mark.cuda
def test_edge_router_on_card_equals_numpy_app(cuda_device):
    """The port's ASGI app over a 2-replica kernel-backend router on the
    card (``device=None``) returns the fragment bodies of a numpy-backend
    app, and the grouped kernel launched."""
    from repro_torch.core import (Request, ServerConfig, TriplePattern,
                                  TripleStore, encode_var)
    from repro_torch.serving.http import TestClient, app_from_config

    v = encode_var
    rng = np.random.default_rng(31)
    arr = np.unique(rng.integers(0, 18, size=(2000, 3)).astype(np.int32),
                    axis=0)
    reqs = []
    for i in range(12):
        s, p, o = (int(x) for x in arr[rng.integers(len(arr))])
        tp = TriplePattern(*[(v(0), p, o), (s, p, v(0)), (v(0), p, v(1)),
                             (v(0), v(1), o)][i % 4])
        omega = None
        if i % 3:
            omega = rng.integers(0, 18, size=(int(rng.integers(1, 30)),
                                              len(tp.variables()))) \
                .astype(np.int32)
        reqs.append(Request(pattern=tp, omega=omega, page=i % 2))

    def bodies(cfg, replicas):
        with TestClient(app_from_config(TripleStore(arr), cfg,
                                        batch_window_s=1e-3,
                                        replicas=replicas)) as tc:
            out = [tc.post("/fragment", json_body=r.to_wire())
                   for r in reqs]
        assert all(r.status_code == 200 for r in out)
        return [r.content for r in out]

    grouped = tbindjoin.bindjoin_grouped_cuda
    before = grouped.launches
    got = bodies(ServerConfig(selector_backend="kernel", page_size=25,
                              fast_path_rows=0), 2)
    launched = grouped.launches - before
    assert got == bodies(ServerConfig(page_size=25), 1)
    assert launched > 0


# The LM serving path: no hand-written kernel, plain torch ops on the card
# against the same parameters on the CPU (float32, TF32 off).
LM_ATOL = 1e-4


def teacher_forced_logits(model, toks, generated, max_seq):
    """The logits the engine sees: prefill of the left-padded prompts,
    then a decode step per generated token. Returns [B, N, V]."""
    dev = model.norm_f.device
    logits, cache = model.prefill(torch.as_tensor(toks, device=dev),
                                  max_seq=max_seq)
    out = [logits[:, 0]]
    for step in range(generated.shape[1] - 1):
        tok = torch.as_tensor(generated[:, step:step + 1].astype(np.int64),
                              device=dev)
        logits, cache = model.decode_step(cache, tok, toks.shape[1] + step)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dispatch", [
    ("qwen2-1.5b", "einsum"), ("granite-moe-1b-a400m", "einsum"),
    ("granite-moe-1b-a400m", "gather")])
def test_lm_engine_on_card_equals_cpu(cuda_device, monkeypatch, arch,
                                      dispatch):
    """The smoke-size engine on the card against the same parameters on
    the CPU: along the CPU's tokens the logits agree within LM_ATOL, and
    the card's tokens equal the CPU's up to the first step whose top-2
    logit gap is within LM_ATOL (a near tie may break either way)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(reduced_for_smoke(get_arch(arch)),
                              moe_dispatch=dispatch)
    card = build_model(cfg, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
    cpu = copy.deepcopy(card).to("cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 4, 6, 12)]
    new, max_seq = 12, 32
    got = ServingEngine(card, max_batch=4, max_seq=max_seq) \
        .generate(prompts, max_new_tokens=new)
    want = ServingEngine(cpu, max_batch=4, max_seq=max_seq) \
        .generate(prompts, max_new_tokens=new)

    toks = np.zeros((4, 12), np.int64)
    for i, p in enumerate(prompts):
        toks[i, 12 - len(p):] = p
    generated = np.stack([r.tokens for r in want])
    with torch.inference_mode():
        lc = teacher_forced_logits(card, toks, generated, max_seq)
        lh = teacher_forced_logits(cpu, toks, generated, max_seq)
    assert float((lc - lh).abs().max()) <= LM_ATOL
    top2 = lh.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    for i in range(4):
        assert got[i].steps == want[i].steps == new
        for step in range(new):
            if gap[i, step] <= LM_ATOL:
                break
            assert got[i].tokens[step] == want[i].tokens[step]


# The training path and the RWKV, Mamba-hybrid and encoder-decoder
# families: plain torch ops on the card against the same parameters on the
# CPU, float32 with TF32 off.
TRAIN_LR = 1e-3
# the loss, and each gradient leaf's largest absolute difference over its
# largest absolute value
GRAD_LOSS_ATOL, GRAD_RTOL = 1e-5, 1e-4
# Adam's first step is lr * g / (|g| + eps) (plus the decay): where the
# two sides' gradients of an element agree to DECIDED (relative), the
# steps agree to PARAM_ATOL; elsewhere (a near-cancelling sum at float32
# noise) the element may move either way, by up to 2 lr.
DECIDED, PARAM_ATOL = 1e-3, 1e-6


def smoke_batch(cfg, device, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 13))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.encoder_layers:
        batch["enc_input"] = rng.normal(size=(2, 5, cfg.d_model)) \
            .astype(np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-1b-a400m",
                                  "rwkv6-7b", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_train_step_on_card_equals_cpu(cuda_device, monkeypatch, arch):
    """One smoke-size grad step and train step per family on the card
    against a copy of the model on the CPU."""
    import copy

    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.launch.steps import make_grad_step, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW, constant_lr

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = reduced_for_smoke(get_arch(arch))
    card = build_model(cfg, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
    cpu = copy.deepcopy(card).to("cpu")
    models = {"card": card, "cpu": cpu}
    batches = {"card": smoke_batch(cfg, "cuda"),
               "cpu": smoke_batch(cfg, "cpu")}
    grads, metrics, params = {}, {}, {}
    opt = AdamW(learning_rate=constant_lr(TRAIN_LR))
    for side, model in models.items():
        p = dict(model.named_parameters())
        grads[side], _ = make_grad_step(model)(p, batches[side])
        p, _, metrics[side] = make_train_step(model, opt)(
            p, opt.init(p), batches[side])
        params[side] = p
    assert abs(float(metrics["card"]["loss"])
               - float(metrics["cpu"]["loss"])) <= GRAD_LOSS_ATOL
    for name, want in grads["cpu"].items():
        got = grads["card"][name].cpu()
        assert torch.isfinite(got).all(), name
        err = float((got - want).abs().max())
        assert err <= GRAD_RTOL * float(want.abs().max()) + 1e-12, name
        decided = (got - want).abs() <= DECIDED * want.abs()
        diff = (params["card"][name].detach().cpu()
                - params["cpu"][name].detach()).abs()
        assert bool((diff[decided] <= PARAM_ATOL).all()), name
        assert bool((diff <= 2 * TRAIN_LR + PARAM_ATOL).all()), name


@pytest.mark.cuda
def test_checkpoint_round_trip_of_cuda_tensors(cuda_device, tmp_path):
    """An async checkpoint of a state tree on the card restores equal,
    onto the card by default and onto the CPU when asked."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamW, constant_lr

    gen = torch.Generator("cuda").manual_seed(0)
    params = {"w": torch.randn(64, 32, device="cuda", generator=gen),
              "b": torch.randn(32, device="cuda", generator=gen)}
    state = {"params": params,
             "opt_state": AdamW(constant_lr(1e-3)).init(params)}
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(3, state)
    with torch.no_grad():
        params["w"].add_(1.0)  # the snapshot was taken before this
    saver.wait()
    step, back = ckpt.restore(str(tmp_path), state)
    assert step == 3 and back["params"]["w"].device.type == "cuda"
    assert torch.equal(back["params"]["w"] + 1.0, params["w"])
    assert torch.equal(back["params"]["b"], params["b"])
    assert back["opt_state"].step.dtype == torch.int32
    _, host = ckpt.restore(str(tmp_path), state, device="cpu")
    assert host["params"]["b"].device.type == "cpu"
    assert torch.equal(host["params"]["b"], params["b"].cpu())


@pytest.mark.cuda
def test_analysis_inventory_matches_the_built_kernels(cuda_device):
    """chip_smoke.py's analysis phase alone: the port's analyzer finds
    nothing in the checkout, its CUDA entries are the four wrappers with
    their sources, and each C symbol resolves on the built library."""
    from repro_torch.kernels import build
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tm = importlib.import_module("repro_torch.kernels.tpf_match")
    out = smoke.check_analysis(build, smoke.kernel_wrappers(tbindjoin, tm),
                               torch.cuda.get_device_name(0))
    assert out["findings"] == 0 and len(out["entries"]) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("t,m", [(1, 64), (5000, 64), (1 << 20, 200)])
def test_registered_kernel_ops_on_card_equal_plain(cuda_device, t, m):
    """``ops.bindjoin`` / ``ops.tpf_match`` reach the kernels through the
    registered ops (``torch.ops.repro_torch``): on the card they equal
    the CPU's plain versions and count their launches; on fake tensors
    the registered fake versions give the shapes and dtypes the kernels
    return."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rng = np.random.default_rng(t)
    triples = torch.as_tensor(rand_triples(rng, t))
    pats = torch.as_tensor(rand_patterns(rng, (m,)))
    pv = torch.as_tensor((rng.random(m) < 0.5).astype(np.int32))
    vec = torch.as_tensor(tops.pattern_vec_from((-1, 2, -1)))
    bj0, tm0 = tbindjoin.bindjoin_cuda.launches, tpf_match_cuda.launches
    got = (*tops.bindjoin(triples.to(cuda_device), pats.to(cuda_device),
                          pv.to(cuda_device)),
           tops.tpf_match(triples.to(cuda_device), vec.to(cuda_device)))
    torch.cuda.synchronize()
    want = (*tops.bindjoin(triples, pats, pv), tops.tpf_match(triples, vec))
    for w, o in zip(want, got, strict=True):
        assert torch.equal(w, o.cpu())
    assert tbindjoin.bindjoin_cuda.launches == bj0 + 1
    assert tpf_match_cuda.launches == tm0 + 1
    # the raw registered ops: fake outputs as the real ones
    cols = [triples[:, i].contiguous().to(cuda_device) for i in range(3)]
    slots = [pats[:, i].contiguous().to(cuda_device) for i in range(3)]
    real = torch.ops.repro_torch.bindjoin(*cols, *slots,
                                          pv.to(cuda_device))
    real_tm = torch.ops.repro_torch.tpf_match(
        triples.to(cuda_device), vec.to(cuda_device))
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = torch.ops.repro_torch.bindjoin(*cols, *slots,
                                              pv.to(cuda_device))
        fake_tm = torch.ops.repro_torch.tpf_match(
            triples.to(cuda_device), vec.to(cuda_device))
    for f, r in zip((*fake, fake_tm), (*real, real_tm), strict=True):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)
