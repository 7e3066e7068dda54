#!/usr/bin/env python3
"""Drive the PyTorch port's brTPF serving paths on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device, ``nvcc`` (on PATH, under ``$CUDA_HOME`` or in
``/usr/local/cuda``) and the ``src/repro_torch`` package beside it;
without them it exits non-zero and prints no result. Phases, each
printing its own lines:

1. device: torch's device name, and the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build: the CUDA kernels build from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) into ``build/repro_torch``;
3. kernels: each hand-written kernel against its plain PyTorch version
   on random inputs at the largest shape the main paths give it, exact
   equality, with the kernel's and the plain version's times and the
   card's bound for the same work (the fused kernel at the MAX_FUSED_*
   ceilings through the reference op's contract, ``ops.bindjoin_fused``);
   the grouped kernel also at one 4 x 1024-row window, the shape the
   earlier design launched it (and tpf_match) at once per page;
4. slice: a WatDiv-like store at 600x the default scale (about 9.25M
   triples, the paper's 10M-triple WatDiv cut only to keep term ids
   under the store's 21-bit packing limit), 8 queries of the L, S, F
   and C families through the sequential brTPF client and through 4
   concurrent async clients on the kernel backend. Solutions and
   fragments must equal the numpy backend's, and each kernel must have
   launched on this path;
5. sharded: the same store as 4 logical shards on the card (the sharded
   backend), the same 8 queries through the sequential client on the
   static placement, through 4 concurrent async clients (the sharded
   fused step), and through the sequential client again after
   ``repartition()`` from the heat log (the routed step); then
   ``execute_full`` (the ungrouped bind-join over every shard's whole
   partition) on each query's first two triple patterns. Everything
   must equal the numpy backend or the host selector, and a sequential
   run must make at most one grouped launch per chunk of pages and no
   tpf_match launch, and the async run exactly one fused launch per
   chunk of an order group's rounds, fewer than its fused rounds. The
   runs of phases 4 and 5 report wall ms per LaunchRecord, and both
   backends CUDA launches per LaunchRecord;
7. edge: the serving edge under the JAX package's chaos plan
   (``benchmarks/chaos.py``) at phase 4's scale: a 4-replica
   ``ReplicaRouter`` on the kernel backend behind the port's ASGI app,
   seed 1608, 5% injected 503s on every replica, replica 1 stalled for
   30 s after 2 requests; 16 async clients over the ASGI transport
   through a ``ResilientTransport`` (retries, hedging, deadlines), the 8
   queries run twice. Every query must complete with the numpy
   backend's solutions, the success rate over client-visible requests
   must be at least 0.999, and the grouped kernel must have launched.
   The same plan with the bare transport and a 2 s client deadline
   (the A/B arm) must fail at least one query;
8. sim: the trace-replay simulator on the card: the kernel profile from
   ``calibrate_kernels``, ``collect_traces`` of the 8 queries on the
   kernel backend, and ``live_replay`` by 4 clients through a 2 ms
   batching window, whose launch count must agree with the model's
   within 10%;
6. path kernels (run after 7 and 8): each kernel against its plain
   version again, at the launch geometries each of phases 4, 5, 7 and 8
   gave it most (the wrappers' ``shapes`` tallies), with times and
   bounds beside that path's launches, and the fused kernel at the
   largest chunk the sharded async run launched.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. Details, phases 7 and 8's numbers among
them, go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and INT32 operations
# per second: 64 INT32 lanes per SM (half the 128 FP32 lanes behind the
# 67 TFLOP/s FP32 figure) x 132 SMs x 1.98 GHz boost clock, one
# operation per lane per clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Work per (row, slot) cell of a bind-join: 3 component compares, 2 ANDs,
# 1 add into the count, 1 min into the first index (wildcard and valid
# flags are per slot, not per cell). The grouped kernel's cells are
# those of its live slots on the rows that pass its prologue.
OPS_PER_CELL = 7
# The ungrouped bind-join keeps no count: 6 operations per cell.
OPS_PER_CELL_UNGROUPED = 6
# Work per row of the single-pattern matcher, and of the grouped
# kernel's prologue: 3 component compares and 3 repeated-variable
# compares.
OPS_PER_ROW = 6

SCALE_FACTOR = 600
NUM_QUERIES_PER_FAMILY = 2
REQUEST_BUDGET = 60
ASYNC_CLIENTS = 4
# Phase 5: logical shards of the sharded backend (its window is the
# backend's default, federation.DEFAULT_SHARD_WINDOW).
SHARDS = 4
# execute_full's attached mappings: the interface's maxMpR.
MAX_MPR = 30
# Phase 7, the serving edge under the JAX package's chaos plan
# (benchmarks/chaos.py): 4 kernel-backend replicas behind the ASGI app,
# 16 clients, seed 1608 (arXiv:1608.08148), 5% injected 503s on every
# replica, replica 1 stalled for 30 s after 2 requests.
EDGE_REPLICAS = 4
EDGE_CLIENTS = 16
PLAN_SEED = 1608
ERROR_RATE = 0.05
STALLED_REPLICA = 1
# The resilient clients' retry policy, and the bare A/B arm's deadline.
RETRY = dict(max_attempts=10, base_backoff_s=2e-3, max_backoff_s=0.05,
             deadline_ms=8000.0, attempt_timeout_ms=300.0, hedge=True)
AB_DEADLINE_MS = 2000.0
# The reference's chaos_c16:success_rate budget.
MIN_SUCCESS_RATE = 0.999
# Phase 8: live replay of the traces by 4 clients through a 2 ms window,
# within the reference's 10% agreement bound (tests/test_batching.py).
SIM_CLIENTS = 4
SIM_WINDOW_S = 2e-3
MAX_SIM_DISAGREEMENT = 0.10


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls. Before each call
    the card writes 256 MiB (so no input is left in the 50 MB L2 cache)
    as many times as it takes to outlast the host's issuing of the call
    (at most about 20 ms), so that a small launch is timed on the device
    and not by the Python and launch overhead the host spends on it."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    fn()
    torch.cuda.synchronize()
    start = event()
    flush.zero_()
    end = event()
    torch.cuda.synchronize()
    flush_ms = max(start.elapsed_time(end), 1e-3)
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    writes = min(max(1, int(2 * host_ms / flush_ms) + 1),
                 max(1, int(20 / flush_ms)))
    total = 0.0
    for _ in range(iters):
        for _ in range(writes):
            flush.zero_()
        start = event()
        fn()
        end = event()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_abs_err(torch, got, want) -> int:
    errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            if g.numel() else 0 for g, w in zip(got, want, strict=True)]
    return max(errs)


def live_bounds(slots):
    """Per group, one past its last slot with valid != 0 (host ints)."""
    valid = (slots[..., 3] != 0).cpu().numpy()
    return [int(np.flatnonzero(v)[-1]) + 1 if v.any() else 0 for v in valid]


def kernel_case(torch, bj, tm, ops, gen, name, shape):
    """Random inputs for kernel ``name`` at launch geometry ``shape``
    (the key of the wrapper's ``shapes`` tally: ``(T,)``, ``(T, M)``,
    ``(P, S, W, G, Mp, live)`` grouped or ``(P, S, W, G, Mp, live,
    Sseg)`` fused). Returns the wrapper call, the plain version's call,
    the view of an output that the two must agree on, the bytes of the
    bound (or a function of the plain output giving them), its
    operations, and facts about the inputs. A grouped or fused case reads
    S shards of P full pages of W rows, every row of its span (the window
    lies in the pattern's range, so every valid row passes the base
    test), against slot tables made as ``marshal_pattern_grid`` makes
    them; a fused case's pages cycle through its Sseg segments. The case
    ``bindjoin_fused_ops`` is the reference op's fused bind-join at
    ``(T, Sseg, G, M)`` (random slots with holes, dead tiles), mapped
    onto the fused kernel by ``ops.fused_tile_pages``."""
    dev = "cuda"

    def same(out):
        return out

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def slots(n, terms):
        out = []
        for _ in range(3):
            x = randint(0, terms, n)
            out.append(torch.where(randint(0, 10, n) < 4,
                                   torch.full_like(x, -1), x))
        out.append((randint(0, 10, n) < 8).to(torch.int32))
        return out

    def windowed(mask, first, cnt, nmatch):
        return [mask, cnt, torch.where(mask.bool(), first, -1)] + (
            [] if nmatch is None else [first, nmatch])

    if name == "tpf_match":
        t = shape[0]
        cand = torch.stack([randint(0, 4, t) for _ in range(3)], dim=1)
        pv = torch.tensor([-1, 2, -1, 0, 1, 0, 0, 0], dtype=torch.int32,
                          device=dev)
        return (lambda: [tm.tpf_match_cuda(cand, pv)],
                lambda: [tm.tpf_match_plain(cand, pv)], same,
                13 * t + 32, OPS_PER_ROW * t, {})
    if name in ("bindjoin_grouped", "bindjoin_fused"):
        p, s, w, g, mp, live = shape[:6]
        segs = shape[6] if name == "bindjoin_fused" else 1
        n = p * w
        pred = torch.full((s * n,), 7, dtype=torch.int32, device=dev)
        triples = torch.stack([randint(0, 64, s * n), pred,
                               randint(0, 64, s * n)], dim=1) \
            .reshape(s, n, 3)
        valid = (randint(0, 10, s * n) < 9).reshape(s, n)
        base = torch.tensor([[-1, 7, -1, 0, 0, 0, 0, 0]] * segs,
                            dtype=torch.int32, device=dev)
        # slot tables as marshal_pattern_grid makes them: each group a
        # live prefix (the first group live slots, the others fewer),
        # then padding; every slot binds the predicate 7 or leaves it
        # wild (a segment's table the grouped case's, from the same draws)
        sl, sp, so, _ = slots(segs * g * mp, 64)
        table = torch.stack([sl, torch.where(sp < 0, sp, 7), so,
                             torch.zeros_like(sl)], dim=1) \
            .reshape(segs, g, mp, 4)
        rng = np.random.default_rng(segs * g * mp + live)
        for si in range(segs):
            fill = rng.integers(1, live + 1, size=g) if live \
                else np.zeros(g, int)
            fill[0] = live
            for gi in range(g):
                table[si, gi, :int(fill[gi]), 3] = 1
        lo = torch.arange(p, device=dev, dtype=torch.int64)[:, None] * w
        spans = torch.stack([lo.expand(p, s), (lo + w).expand(p, s)],
                            dim=-1).contiguous()
        kw = dict(spans=spans, width=w, live=live)
        if name == "bindjoin_grouped":
            args = (triples, valid, table[0], base[0])
            fn, plain = bj.bindjoin_grouped_cuda, bj.bindjoin_grouped_plain
        else:
            args = (triples, valid, table, base)
            kw["seg_of_page"] = torch.arange(
                p, dtype=torch.int32, device=dev) % segs
            fn, plain = bj.bindjoin_fused_cuda, bj.bindjoin_fused_plain
        rows = p * s * w
        # every span is a full page: a page's rows that pass are its valid
        # rows, each against its own segment's live slots
        ok_per_page = valid.reshape(s, p, w).sum(dim=(0, 2)).cpu().numpy()
        live_cells = [sum(live_bounds(table[si])) for si in range(segs)]
        cells = sum(int(k) * live_cells[i % segs]
                    for i, k in enumerate(ok_per_page))

        def nbytes(want):
            return (13 * rows + rows * g + 4 * int(want[0].sum())
                    + 8 * p * s * g + 16 * sum(live_cells) + 16 * p * s
                    + 4 * p + 32 * segs)

        return (lambda: fn(*args, **kw), lambda: plain(*args, **kw),
                lambda out: windowed(*out), nbytes,
                OPS_PER_ROW * rows + OPS_PER_CELL * cells,
                dict(rows_ok=int(ok_per_page.sum()), live_cells=live_cells))
    if name == "bindjoin_fused_ops":
        t, segs, g, m = shape
        cand = torch.stack([randint(0, 64, t) for _ in range(3)], dim=1)
        seg = randint(-1, segs, t // 256)
        pats = slots(segs * g * m, 64)
        patterns = torch.stack(pats[:3], dim=1).reshape(segs, g, m, 3)
        pat_valid = pats[3].reshape(segs, g, m)
        got = ops.bindjoin_fused(cand, seg, patterns, pat_valid)
        want = ops.bindjoin_fused(cand.cpu(), seg.cpu(), patterns.cpu(),
                                  pat_valid.cpu())
        if not all(torch.equal(a.cpu(), b)
                   for a, b in zip(got, want, strict=True)):
            raise SmokeFailure("ops.bindjoin_fused on the card differs "
                               "from its plain version")
        args, kw = ops.fused_tile_pages(cand, seg, patterns, pat_valid)
        # each live tile's rows against its own segment's live slots
        per_seg = [sum(live_bounds(args[2][si])) for si in range(segs)]
        seg_h = seg.cpu().numpy()
        rows_ok = 256 * int((seg_h >= 0).sum())
        cells = 256 * sum(per_seg[x] for x in seg_h if x >= 0)

        def nbytes(want):
            # rows of 12 bytes (no valid flags); dense outputs (mask,
            # first and nmatch for every row and group); per page its
            # span, segment and G cnt sums; the tables
            pages = t // 256
            return (12 * t + 9 * t * g + pages * (20 + 8 * g)
                    + 16 * segs * g * args[2].shape[2] + 32 * segs)

        return (lambda: bj.bindjoin_fused_cuda(*args, **kw),
                lambda: bj.bindjoin_fused_plain(*args, **kw),
                lambda out: windowed(*out), nbytes,
                OPS_PER_ROW * t + OPS_PER_CELL * cells,
                dict(rows_ok=rows_ok, mapped_shape=[
                    t // 256, 1, 256, g, args[2].shape[2], kw["live"],
                    segs]))
    t = shape[0]
    cand = [randint(0, 64, t) for _ in range(3)]
    m = shape[1]
    pats = slots(m, 64)
    pats[3][MAX_MPR:] = 0          # maxMpR valid slots, then padding
    return (lambda: bj.bindjoin_cuda(*cand, *pats),
            lambda: bj.bindjoin_plain(*cand, *pats), same,
            20 * t + 16 * m, OPS_PER_CELL_UNGROUPED * t * m, {})


def measure(torch, bj, tm, ops, gen, name, shape):
    """One kernel case: exact agreement with the plain version, the
    kernel's and the plain version's device ms, and the bound."""
    fn, plain_fn, view, nbytes, n_ops, facts = kernel_case(
        torch, bj, tm, ops, gen, name, shape)
    got, want = view(fn()), view(plain_fn())
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    ms = time_ms(torch, fn, 20)
    plain = time_ms(torch, plain_fn, 3)
    b, by = bound_ms(nbytes(want) if callable(nbytes) else nbytes, n_ops)
    r = dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain,
             bound_ms=b, bound_by=by, kept=int(want[0].sum()), **facts)
    log(f"kernel {name}: shape {list(shape)}"
        + (f" as {facts['mapped_shape']}" if "mapped_shape" in facts
           else "")
        + f" max_abs_err={err} ms={ms:.4f} plain_ms={plain:.4f} "
        f"bound_ms={b:.4f} ({by}) "
        "library_ms=null (no single PyTorch call computes it)")
    if err != 0:
        raise SmokeFailure(f"{name} disagrees with its plain version at "
                           f"{list(shape)}")
    return r


def check_kernels(torch, bj, tm, ops, t_full: int):
    """Phase 3: each kernel against its plain version at the largest
    shape a main path gives it (``t_full``: the sharded store's rows,
    shards x shard_n, which execute_full streams at once). Returns those
    rows, and the grouped kernel at the single-window shape of the
    earlier design, which launched it (and tpf_match) once per page."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = {
        # tpf_match at execute_full's shape (the only path launching it)
        "tpf_match": measure(torch, bj, tm, ops, gen, "tpf_match",
                             (t_full,)),
        # bindjoin_grouped at the chunk cap (federation.MAX_CHUNK_ROWS):
        # 1024 pages x 4 shards x 1024 rows, G = 8 groups of Mp = 128
        # slots, maxMpR = 30 of them live
        "bindjoin_grouped": measure(torch, bj, tm, ops, gen,
                                    "bindjoin_grouped",
                                    (1024, SHARDS, 1024, 8, 128, MAX_MPR)),
        # bindjoin_fused at the MAX_FUSED_* ceilings, through the
        # reference op's contract: 131072 rows, 16 segments x 2 groups x
        # 1024 slots = 32768 slots (the shape the flat-stream fused
        # kernel of the first design was timed at)
        "bindjoin_fused": measure(torch, bj, tm, ops, gen,
                                  "bindjoin_fused_ops",
                                  (131_072, 16, 2, 1024)),
        # bindjoin (ungrouped) at execute_full's shape: every shard's
        # whole partition, padded to 1024 rows, against maxMpR = 30
        # slots padded to M = 128
        "bindjoin": measure(torch, bj, tm, ops, gen, "bindjoin",
                            (-(-t_full // 1024) * 1024, 128)),
    }
    # one window of 4 shards x 1024 rows, G = 1, Mp = 128, one live slot
    single = measure(torch, bj, tm, ops, gen, "bindjoin_grouped",
                     (1, SHARDS, 1024, 1, 128, 1))
    return kernels, single


def check_path_geometries(torch, bj, tm, ops, shapes_per_path):
    """Phase 6: each kernel against its plain version at the launch
    geometries each main path gave it (from the wrappers' ``shapes``
    tallies), most launched first, until they cover 90% of that path's
    launches of the kernel (at most 3), and the fused kernel also at the
    largest chunk (most rows) the sharded path launched. Returns, per
    kernel, per path: launches, share covered, the launches x (ms -
    bound) excess of the covered geometries, and each geometry's
    measurement; and the largest sharded fused chunk's measurement."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    seen = {}
    out = {}

    def timed(name, shape):
        if (name, shape) not in seen:
            seen[(name, shape)] = measure(torch, bj, tm, ops, gen, name,
                                          shape)
        return seen[(name, shape)]

    for path, per_kernel in shapes_per_path.items():
        for name, tally in per_kernel.items():
            total = sum(tally.values())
            if not total:
                continue
            geoms, covered, excess = [], 0, 0.0
            for shape, n in tally.most_common(3):
                r = timed(name, shape)
                geoms.append(dict(r, launches=n))
                covered += n
                excess += n * (r["ms"] - r["bound_ms"])
                if covered >= 0.9 * total:
                    break
            out.setdefault(name, {})[path] = dict(
                launches=total, covered=covered / total,
                excess_ms=excess, geometries=geoms)
            log(f"path {path}: {name} {total} launches, "
                f"{100 * covered / total:.1f}% at the {len(geoms)} "
                f"geometries timed, launches x (ms - bound) "
                f"{excess:.1f} ms")
    # main() has checked that the sharded path launched the fused kernel
    fused = shapes_per_path["sharded backend"]["bindjoin_fused"]
    largest = max(fused, key=lambda k: (k[0] * k[1] * k[2], k))
    chunk = dict(timed("bindjoin_fused", largest), launches=fused[largest])
    log(f"path sharded backend: bindjoin_fused largest chunk "
        f"{list(largest)} ({chunk['launches']} launches): "
        f"ms={chunk['ms']:.4f} bound_ms={chunk['bound_ms']:.4f} "
        f"({chunk['bound_by']}) plain_ms={chunk['plain_ms']:.4f}")
    return out, chunk


def pick_queries(watdiv, data):
    """The first NUM_QUERIES_PER_FAMILY queries of each of the L, S, F
    and C families from ``generate_workload(seed=1)``."""
    out, seen = [], {}
    for name, bgp in watdiv.generate_workload(data, 145, seed=1):
        fam = name[0]
        if seen.get(fam, 0) < NUM_QUERIES_PER_FAMILY:
            seen[fam] = seen.get(fam, 0) + 1
            out.append((name, bgp))
    if sorted(seen) != ["C", "F", "L", "S"]:
        raise SmokeFailure(f"workload misses a family: {seen}")
    return out


class RecordingFront:
    """Async front end wrapper that keeps every (request, fragment) it
    served, so each fragment can be checked against the numpy oracle."""

    def __init__(self, front):
        self.front = front
        self.server = front.server
        self.max_mpr = front.max_mpr
        self.log = []

    async def handle(self, req):
        frag = await self.front.handle(req)
        self.log.append((req, frag))
        return frag


def same_fragment(a, b) -> bool:
    return (a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
            and a.data.tobytes() == b.data.tobytes() and a.cnt == b.cnt
            and a.has_next == b.has_next)


def generate_data(watdiv):
    """The slice's store: WatDiv-like at SCALE_FACTOR x the default."""
    t0 = time.perf_counter()
    base = watdiv.WatDivScale()
    scale = watdiv.WatDivScale(**{
        f: getattr(base, f) * SCALE_FACTOR
        for f in ("users", "products", "reviews", "retailers", "genres",
                  "cities", "tags")})
    data = watdiv.generate(scale, seed=0)
    generate_s = time.perf_counter() - t0
    log(f"slice data: {len(data.store)} triples, {len(data.dictionary)} "
        f"terms, generated in {generate_s:.1f}s")
    return data, generate_s


def same_solutions(a, b) -> bool:
    return (a.solutions.shape == b.solutions.shape
            and (a.solutions == b.solutions).all()
            and (a.num_requests, a.data_received, a.timed_out)
            == (b.num_requests, b.data_received, b.timed_out))


def drive_async(torch, core, server, queries):
    """4 concurrent async clients over the batching front end: every
    heterogeneous window goes through a fused step. Returns the
    recording front end, the per-client results and the seconds."""
    front = RecordingFront(core.AsyncBrTPFServer(server))
    work = [list(range(len(queries)))[i::ASYNC_CLIENTS]
            for i in range(ASYNC_CLIENTS)]

    async def drive():
        try:
            clients = [core.AsyncBrTPFClient(front,
                                             request_budget=REQUEST_BUDGET)
                       for _ in work]
            return await asyncio.gather(*[
                c.run_workload([queries[i] for i in w])
                for c, w in zip(clients, work, strict=True)])
        finally:
            await front.front.aclose()

    t0 = time.perf_counter()
    ares = asyncio.run(drive())
    torch.cuda.synchronize()
    return front, list(zip(work, ares, strict=True)), \
        time.perf_counter() - t0


def check_async(core, store, front, results, queries, nres, label):
    """Every async fragment against the numpy backend's, byte for byte,
    and every finished query's solutions. Returns the seconds taken."""
    oracle = core.BrTPFServer(store, core.ServerConfig())
    t0 = time.perf_counter()
    for req, frag in front.log:
        if not same_fragment(frag, oracle.handle(req)):
            raise SmokeFailure(f"{label} async fragment for {req.pattern} "
                               f"page {req.page} differs from the numpy "
                               "backend")
    for w, res in results:
        for i, r in zip(w, res, strict=True):
            n = nres[i]
            if not r.timed_out and not n.timed_out and not (
                    r.solutions.shape == n.solutions.shape
                    and (r.solutions == n.solutions).all()):
                raise SmokeFailure(f"{label} async query {queries[i][0]}: "
                                   "solutions differ")
    return time.perf_counter() - t0


def run_slice(torch, core, data, queries, counts, reset_counts):
    """Phase 4: the serving slice at real scale on the kernel backend.
    Returns details and the numpy backend's results."""
    details = {}
    kcfg = core.ServerConfig(selector_backend="kernel", fast_path_rows=0)
    kserver = core.BrTPFServer(data.store, kcfg)
    nserver = core.BrTPFServer(data.store, core.ServerConfig())

    # Sequential brTPF client: kernel backend against numpy backend.
    reset_counts()
    t0 = time.perf_counter()
    kres = [core.BrTPFClient(kserver, request_budget=REQUEST_BUDGET)
            .execute(b) for _, b in queries]
    torch.cuda.synchronize()
    details["sync_kernel_s"] = time.perf_counter() - t0
    sync_counts = counts("kernel backend")
    sync_records = len(kserver._selector.launches)
    t0 = time.perf_counter()
    nres = [core.BrTPFClient(nserver, request_budget=REQUEST_BUDGET)
            .execute(b) for _, b in queries]
    details["sync_numpy_s"] = time.perf_counter() - t0
    per_query = []
    for (name, _), k, n in zip(queries, kres, nres, strict=True):
        if not same_solutions(k, n):
            raise SmokeFailure(f"query {name}: kernel backend differs "
                               "from the numpy backend")
        per_query.append(dict(query=name, solutions=int(k.solutions.shape[0]),
                              requests=k.num_requests,
                              timed_out=k.timed_out))
    host_ms = 1e3 * details["sync_kernel_s"] / max(sync_records, 1)
    details["sync"] = dict(queries=per_query,
                           requests=kserver.counters.num_requests,
                           counters=dataclasses.asdict(kserver.counters),
                           launches=sync_counts, launch_records=sync_records,
                           ms_per_launch_record=host_ms)
    log(f"slice sync: {kserver.counters.num_requests} requests, kernel "
        f"{details['sync_kernel_s']:.1f}s, numpy "
        f"{details['sync_numpy_s']:.1f}s, solutions equal; launches "
        f"{sync_counts}; {sync_records} LaunchRecords, {host_ms:.3f} ms "
        "of wall time per LaunchRecord")

    # Concurrent async clients over the batching front end: every
    # heterogeneous window goes through the fused kernel.
    aserver = core.BrTPFServer(data.store, kcfg)
    reset_counts()
    front, ares, details["async_kernel_s"] = drive_async(
        torch, core, aserver, queries)
    async_counts = counts("kernel backend")
    details["async_numpy_check_s"] = check_async(
        core, data.store, front, ares, queries, nres, "kernel")
    stats = front.front.stats
    details["async"] = dict(requests=len(front.log),
                            counters=dataclasses.asdict(aserver.counters),
                            flushes=stats.flushes,
                            mean_batch=stats.mean_batch,
                            launches=async_counts)
    log(f"slice async: {ASYNC_CLIENTS} clients, {len(front.log)} requests, "
        f"{stats.flushes} flushes (mean batch {stats.mean_batch:.2f}), "
        f"{aserver.counters.fused_launches} fused launches, kernel "
        f"{details['async_kernel_s']:.1f}s, every fragment equals the numpy "
        f"backend's ({details['async_numpy_check_s']:.1f}s); launches "
        f"{async_counts}")
    details["requests"] = kserver.counters.num_requests + len(front.log)
    details["launches"] = {k: sync_counts[k] + async_counts[k]
                           for k in sync_counts}
    details["launch_records"] = sync_records + len(aserver._selector.launches)

    # Not part of the counted main path: the sequential client once
    # more, on a fresh kernel server, under the profiler.
    details["profile"] = profile_sync(torch, core, data.store, kcfg, queries)
    log_profile("slice profile: sync kernel run", details["profile"])
    return details, nres


def log_profile(label, p):
    log(f"{label} {p['wall_s']:.2f}s wall under the profiler, device busy "
        f"{p['device_busy_s']:.3f}s ({100 * p['busy_share']:.1f}%); top "
        "device time (ms): "
        + ", ".join(f"{k} {ms:.1f}" for k, ms in p["top"][:5]))


def bgp_mappings(core, tp, triples, num_vars, limit):
    """The first ``limit`` distinct solution mappings of ``tp`` over its
    matching ``triples`` (the Omega a client would attach next)."""
    rows = []
    for t in triples:
        mu = core.mapping_from_triple(tp, t, num_vars)
        if mu is not None:
            rows.append(mu)
            if len(rows) == limit:
                break
    if not rows:
        return None
    return core.dedup_mappings(np.stack(rows))[:limit]


def check_execute_full(core, store, fed, queries):
    """``execute_full`` on each query's first triple pattern with no
    mappings, and on its second with the first's first MAX_MPR
    solution mappings; rows, sorted, against the host selector's. Each
    shard's page capacity is the power of two above the host's row
    count (capped at the shard size), so no page can be truncated."""
    def sorted_rows(x):
        return x[np.lexsort((x[:, 2], x[:, 1], x[:, 0]))]

    out = []
    for name, bgp in queries:
        tps = list(bgp.patterns[:2])
        first, _ = core.brtpf_select_with_cnt(store, tps[0], None)
        wants = [first]
        omegas = [None]
        if len(tps) == 2:
            omegas.append(bgp_mappings(core, tps[0], first, bgp.num_vars,
                                       MAX_MPR))
            wants.append(core.brtpf_select_with_cnt(store, tps[1],
                                                    omegas[1])[0])
        for tp, omega, want in zip(tps, omegas, wants):
            cap = 1
            while cap < max(len(want), 1):
                cap *= 2
            cap = min(cap, fed.shard_n)
            got = fed.execute_full(tp, omega, MAX_MPR, cap)
            if len(got) != len(want) or not np.array_equal(
                    sorted_rows(got), sorted_rows(want)):
                raise SmokeFailure(f"execute_full {name} {tp}: "
                                   f"{len(got)} rows, host {len(want)}")
            out.append(dict(query=name, rows=int(len(want)), capacity=cap,
                            mappings=0 if omega is None
                            else int(omega.shape[0])))
    return out


def run_sharded(torch, core, data, queries, nres, counts, reset_counts):
    """Phase 5: the sharded backend, SHARDS logical shards on the card,
    on the static placement (sync and async) and after a heat
    repartition (the routed step), then execute_full."""
    details = {}
    scfg = core.ServerConfig(selector_backend="sharded", shards=SHARDS,
                             fast_path_rows=0, placement_policy="heat")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server = core.BrTPFServer(data.store, scfg)
    torch.cuda.synchronize()
    fed = server.federated
    details["build_s"] = time.perf_counter() - t0
    details["device_bytes"] = fed.nbytes
    details["shard_n"] = fed.shard_n
    log(f"sharded store: {SHARDS} logical shards x {fed.shard_n} rows, 3 "
        f"orders on the device, {fed.nbytes / 1e9:.3f} GB, built in "
        f"{details['build_s']:.1f}s; window "
        f"{server._selector.window}")

    def sequential(label, srv):
        sel = srv._selector
        n0 = len(sel.launches)
        c0 = sel.grouped_chunks
        reset_counts()
        t0 = time.perf_counter()
        res = [core.BrTPFClient(srv, request_budget=REQUEST_BUDGET)
               .execute(b) for _, b in queries]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = counts("sharded backend")
        for (name, _), r, n in zip(queries, res, nres, strict=True):
            if not same_solutions(r, n):
                raise SmokeFailure(f"sharded {label} query {name}: differs "
                                   "from the numpy backend")
        chunks = sel.grouped_chunks - c0
        if launched["bindjoin_grouped"] > chunks or launched["tpf_match"]:
            raise SmokeFailure(f"sharded {label}: {launched} for {chunks} "
                               "chunks (at most one grouped launch per "
                               "chunk, no tpf_match launch)")
        records = len(sel.launches) - n0
        out = dict(seconds=secs, requests=srv.counters.num_requests,
                   launch_records=records, launches=launched,
                   grouped_chunks=chunks,
                   ms_per_launch_record=1e3 * secs / max(records, 1),
                   shards=srv.metrics_snapshot()["shards"])
        log(f"sharded {label}: {out['requests']} requests in {secs:.1f}s, "
            f"{records} LaunchRecords in {chunks} chunks "
            f"({out['ms_per_launch_record']:.3f} ms of wall time per "
            "LaunchRecord), solutions and request counts equal the numpy "
            f"backend's; launches {launched}; shard imbalance "
            f"{out['shards']['imbalance']:.2f}")
        return out

    details["static"] = sequential("static", server)

    aserver = core.BrTPFServer(data.store,
                               scfg.replace(placement_policy="static"))
    asel = aserver._selector
    n0, f0 = len(asel.launches), asel.fused_chunks
    reset_counts()
    front, ares, secs = drive_async(torch, core, aserver, queries)
    launched = counts("sharded backend")
    check_s = check_async(core, data.store, front, ares, queries, nres,
                          "sharded")
    stats = front.front.stats
    records = asel.launches[n0:]
    # a fused round of two or more segments (the server's fused launches)
    fused_records = sum(r.segments >= 2 for r in records)
    fused_chunks = asel.fused_chunks - f0
    details["async"] = dict(
        seconds=secs, requests=len(front.log),
        launch_records=len(records), launches=launched,
        flushes=stats.flushes, fused_chunks=fused_chunks,
        fused_launch_records=fused_records,
        fused_launches=aserver.counters.fused_launches,
        ms_per_launch_record=1e3 * secs / max(len(records), 1),
        check_s=check_s)
    log(f"sharded async: {ASYNC_CLIENTS} clients, {len(front.log)} requests "
        f"in {secs:.1f}s, {stats.flushes} flushes, {len(records)} "
        f"LaunchRecords ({details['async']['ms_per_launch_record']:.3f} ms "
        "of wall time per LaunchRecord), every fragment equals the numpy "
        f"backend's ({check_s:.1f}s); launches {launched}")
    log(f"sharded async fused: {fused_chunks} fused chunks, "
        f"{launched['bindjoin_fused']} bindjoin_fused CUDA launches, "
        f"{fused_records} fused LaunchRecords (rounds of two or more "
        "segments)")
    if launched["bindjoin_fused"] != fused_chunks \
            or not 0 < fused_chunks < fused_records:
        raise SmokeFailure(
            f"sharded async: {launched['bindjoin_fused']} bindjoin_fused "
            f"launches for {fused_chunks} fused chunks and {fused_records} "
            "fused LaunchRecords (one launch per chunk, fewer chunks than "
            "rounds)")

    t0 = time.perf_counter()
    server.repartition()
    server.reset_counters()
    torch.cuda.synchronize()
    placement = server.federated.placement
    if placement is None:
        raise SmokeFailure("repartition left no placement")
    details["repartition_s"] = time.perf_counter() - t0
    details["replicas"] = sum(len(v) for v in placement.replicas.values())
    log(f"sharded repartition: {details['repartition_s']:.1f}s from "
        f"{len(server._heat)} heat records, {details['replicas']} replica "
        f"ranges, shard_n {server.federated.shard_n}")
    details["routed"] = sequential("routed", server)

    reset_counts()
    t0 = time.perf_counter()
    details["execute_full"] = check_execute_full(core, data.store, fed,
                                                 queries)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    details["execute_full_launches"] = counts("execute_full")
    log(f"sharded execute_full: {len(details['execute_full'])} requests in "
        f"{full_s:.1f}s, rows equal the host selector's, none truncated; "
        f"launches {details['execute_full_launches']}")

    # Not part of the counted main path: the static sequential run once
    # more, on a fresh sharded server, under the profiler.
    details["profile"] = profile_sync(
        torch, core, data.store, scfg.replace(placement_policy="static"),
        queries)
    log_profile("sharded profile: sync static run", details["profile"])
    return details


class OutcomeTransport:
    """Counts and times request outcomes at one level of the stack:
    above the resilience, the client-visible requests (the chaos run's
    success rate and latency); below it, each attempt. ``calls`` keeps
    every call's (start, end, exception name or None)."""

    def __init__(self, inner):
        self.inner = inner
        self.max_mpr = inner.max_mpr
        self.ok = 0
        self.failed = 0
        self.samples_s = []
        self.calls = []

    async def handle(self, req):
        t0 = time.perf_counter()
        try:
            frag = await self.inner.handle(req)
        except Exception as exc:
            self.failed += 1
            self.calls.append((t0, time.perf_counter(), type(exc).__name__))
            raise
        self.ok += 1
        self.samples_s.append(time.perf_counter() - t0)
        self.calls.append((t0, time.perf_counter(), None))
        return frag

    async def metrics(self):
        return await self.inner.metrics()

    async def aclose(self):
        await self.inner.aclose()


def chaos_arm(torch, core, data, queries, nres, resilient):
    """One arm of the chaos run: a fresh 4-replica router under the plan,
    the ASGI app in front of it, 16 async clients over the ASGI
    transport (through a ResilientTransport, or bare with a client
    deadline for the A/B arm), each query run twice, split as the
    reference's split_workload splits it. Returns the outcome and the
    router."""
    from repro_torch.core import metrics, sim
    from repro_torch.serving import faults, http, resilience, router
    from repro_torch.serving import transport
    plan = faults.FaultPlan(
        seed=PLAN_SEED, default=faults.FaultSpec(error_rate=ERROR_RATE),
        per_replica={STALLED_REPLICA: faults.FaultSpec(
            error_rate=ERROR_RATE, stall_after=2, stall_s=30.0)})
    rtr = router.ReplicaRouter(
        data.store, core.ServerConfig(selector_backend="kernel",
                                      fast_path_rows=0),
        replicas=EDGE_REPLICAS, fault_plan=plan, failure_threshold=2,
        reset_after_s=0.5)
    attempts = OutcomeTransport(
        transport.AsgiTransport(http.create_app(rtr)))
    inner = (resilience.ResilientTransport(
        attempts, resilience.RetryPolicy(**RETRY), seed=PLAN_SEED)
        if resilient else attempts)
    probe = OutcomeTransport(inner)
    work = sim.split_workload(list(range(len(queries))) * 2, EDGE_CLIENTS)
    outcome = {"failed_queries": 0, "mismatches": 0, "solved": 0}

    async def one(client, idxs):
        for i in idxs:
            try:
                res = await client.execute(queries[i][1])
            except Exception:
                outcome["failed_queries"] += 1
                continue
            outcome["solved"] += 1
            want = nres[i]
            if res.timed_out != want.timed_out or not (
                    res.solutions.shape == want.solutions.shape
                    and (res.solutions == want.solutions).all()):
                outcome["mismatches"] += 1

    async def drive():
        clients = [core.AsyncBrTPFClient(
            probe, request_budget=REQUEST_BUDGET,
            deadline_ms=None if resilient else AB_DEADLINE_MS)
            for _ in work]
        try:
            await asyncio.gather(*[one(c, w) for c, w in
                                   zip(clients, work, strict=True)])
            snap = await probe.metrics()
        finally:
            t0 = time.perf_counter()
            await probe.aclose()
            outcome["aclose_s"] = time.perf_counter() - t0
        return snap

    t0 = time.perf_counter()
    snap = asyncio.run(drive())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = metrics.chaos_summary(
        probe.ok, probe.failed, outcome["failed_queries"], probe.samples_s,
        wall_s=wall, parity=float(outcome["mismatches"] == 0))
    res = snap["resilience"]
    records = sum(len(r.server._selector.launches) for r in rtr.replicas)
    out.update(
        wall_s=wall, queries=sum(len(w) for w in work),
        solved_queries=outcome["solved"], mismatches=outcome["mismatches"],
        aclose_s=outcome["aclose_s"], retries=res["retries"],
        hedges=res["hedges"], hedge_wins=res["hedge_wins"],
        shed=res["shed"], breaker_opens=res["breaker"]["opens"],
        failovers=res["breaker"]["failovers"],
        replica_failures=res["breaker"]["replica_failures"],
        requests_per_replica=snap["router"]["requests_per_replica"],
        faults=snap["faults"], launch_records=records,
        ms_per_launch_record=1e3 * wall / max(records, 1),
        hedging=hedge_diagnosis(attempts.calls, resilience))
    return out


def hedge_diagnosis(calls, resilience):
    """Why the resilient arm hedged as often as it did. A
    ResilientTransport hedges an attempt still open after the p95 of
    the successful attempts that ended before it began (its last
    LATENCY_WINDOW), once ``hedge_min_samples`` of them exist; an
    attempt is cut at ``attempt_timeout_ms``. Replays that rule over
    the attempts' own spans: for each attempt cut at the timeout, how
    many successes it could see and the hedge delay then in force."""
    policy = resilience.RetryPolicy(**RETRY)
    window = resilience.ResilientTransport.LATENCY_WINDOW
    start = min(t0 for t0, _, _ in calls)
    oks = sorted((t1, t1 - t0) for t0, t1, err in calls if err is None)
    cap_s = policy.attempt_timeout_ms / 1e3
    cut, would_hedge = [], 0
    for t0, t1, err in calls:
        seen = [d for end, d in oks if end <= t0][-window:]
        delay = None
        if len(seen) >= policy.hedge_min_samples:
            ordered = sorted(seen)
            delay = ordered[min(len(ordered) - 1,
                                int(0.95 * len(ordered)))]
            would_hedge += t1 - t0 > delay
        if err is not None and t1 - t0 >= 0.95 * cap_s:
            cut.append(dict(start_s=t0 - start, successes_seen=len(seen),
                            hedge_delay_ms=None if delay is None
                            else 1e3 * delay, error=err))
    reached = (oks[policy.hedge_min_samples - 1][0] - start
               if len(oks) >= policy.hedge_min_samples else None)
    return dict(attempts=len(calls), cut=cut, would_hedge=would_hedge,
                min_samples=policy.hedge_min_samples,
                min_samples_reached_s=reached)


def run_edge(torch, core, data, queries, nres, counts, reset_counts):
    """Phase 7: the serving edge under the chaos plan at the slice's
    scale, then the bare A/B arm (not counted as the edge path)."""
    reset_counts()
    r = chaos_arm(torch, core, data, queries, nres, resilient=True)
    r["launches"] = counts("edge")
    log(f"edge: {EDGE_REPLICAS} kernel-backend replicas behind the ASGI "
        f"app, {EDGE_CLIENTS} resilient clients, {r['queries']} queries "
        f"({r['solved_queries']} completed, {r['failed_queries']} failed, "
        f"{r['mismatches']} differ from the numpy oracle), "
        f"{r['ok']} requests ok / {r['failed']} failed, success rate "
        f"{r['success_rate']:.4f}, p50 {r['p50_latency_ms']:.1f} ms, p99 "
        f"{r['p99_latency_ms']:.1f} ms, wall {r['wall_s']:.2f}s")
    log(f"edge resilience: retries {r['retries']}, hedges {r['hedges']} "
        f"({r['hedge_wins']} won), breaker opens {r['breaker_opens']}, "
        f"failovers {r['failovers']}, replica failures "
        f"{r['replica_failures']}, shed {r['shed']}; requests per replica "
        f"{r['requests_per_replica']}; aclose {r['aclose_s']:.3f}s")
    h = r["hedging"]
    early = sum(c["hedge_delay_ms"] is None for c in h["cut"])
    delays = [c["hedge_delay_ms"] for c in h["cut"]
              if c["hedge_delay_ms"] is not None]
    log(f"edge hedging: {h['attempts']} attempts, {len(h['cut'])} cut at "
        f"the {RETRY['attempt_timeout_ms']:.0f} ms attempt timeout, at "
        + ", ".join(f"{c['start_s']:.3f}s" for c in h["cut"])
        + f" ({early} began before "
        f"{h['min_samples']} successes had ended, which the "
        "p95 hedge delay needs; the delay at the others "
        + (f"{min(delays):.1f}-{max(delays):.1f} ms" if delays else "-")
        + f"); {h['min_samples_reached_s']}s until that many ended; "
        f"attempts the rule would hedge {h['would_hedge']}")
    log(f"edge launches: {r['launches']}; {r['launch_records']} "
        f"LaunchRecords, {r['ms_per_launch_record']:.3f} ms of wall time "
        "per LaunchRecord")
    if (r["failed_queries"] or r["mismatches"]
            or r["success_rate"] < MIN_SUCCESS_RATE):
        raise SmokeFailure(
            f"edge: {r['failed_queries']} queries failed, "
            f"{r['mismatches']} differ from the oracle, success rate "
            f"{r['success_rate']:.4f} (needs >= {MIN_SUCCESS_RATE})")
    ab = chaos_arm(torch, core, data, queries, nres, resilient=False)
    log(f"edge A/B (bare transport, {AB_DEADLINE_MS:.0f} ms client "
        f"deadline): {ab['failed_queries']} of {ab['queries']} queries "
        f"failed, success rate {ab['success_rate']:.4f}, wall "
        f"{ab['wall_s']:.2f}s, aclose {ab['aclose_s']:.3f}s")
    if ab["failed_queries"] < 1 or ab["mismatches"]:
        raise SmokeFailure(f"edge A/B: {ab['failed_queries']} queries "
                           f"failed, {ab['mismatches']} differ (the plan "
                           "must fail at least one query without "
                           "resilience, and never change a result)")
    return dict(resilient=r, ab=ab)


def run_sim(torch, core, data, queries, counts, reset_counts):
    """Phase 8: the simulator on the card. The kernel profile first (not
    counted), then the counted path: trace collection on the kernel
    backend and the live replay through the async front end."""
    from torch.profiler import ProfilerActivity, profile as profiler

    from repro_torch.core import sim
    t0 = time.perf_counter()
    profile = sim.calibrate_kernels()
    calibrate_s = time.perf_counter() - t0
    log("sim kernel profile (calibrate_kernels): " + ", ".join(
        f"{k} {v:.4e}" for k, v in profile.items())
        + f" ({calibrate_s:.1f}s)")
    cfg = core.ServerConfig(selector_backend="kernel", fast_path_rows=0)
    reset_counts()
    t0 = time.perf_counter()
    with profiler(activities=[ProfilerActivity.CUDA]) as prof:
        traces = sim.collect_traces(core.BrTPFServer(data.store, cfg),
                                    queries, "brtpf",
                                    request_budget=REQUEST_BUDGET)
        torch.cuda.synchronize()
    joins = [ns for name, ns in device_events(torch, prof)
             if "bindjoin" in name]
    kernel_device_s = sum(joins) / 1e9
    model, model_requests = model_kernel_s(sim, traces,
                                           sim.SimParams(**profile))
    # A query cut by the request budget leaves a trace of its first
    # REQUEST_BUDGET requests, which the model would skip whole (it
    # replays a trace only if the query completed) while the live front
    # end serves every request of it: both replay the same recorded
    # requests once each trace counts as complete.
    truncated = sum(not t.completed for t in traces)
    traces = [dataclasses.replace(t, completed=True) for t in traces]
    params = sim.calibrate(core.BrTPFServer(data.store, cfg), queries)
    params = dataclasses.replace(params, **profile)
    lv = sim.live_replay(sim.split_workload(traces, SIM_CLIENTS),
                         core.BrTPFServer(data.store, cfg), params,
                         batch_window_s=SIM_WINDOW_S)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = counts("sim")
    out = dict(profile=profile, calibrate_s=calibrate_s, seconds=secs,
               launches=launched, within=lv.within, truncated=truncated,
               live=dataclasses.asdict(lv),
               params=dataclasses.asdict(params),
               collect_launches=len(joins),
               kernel_device_s=kernel_device_s, model_kernel_s=model)
    log(f"sim kernel time of trace collection: the model charges "
        f"{1e3 * sum(model.values()):.3f} ms ("
        + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in model.items())
        + f") for {model_requests} kernel-path requests; "
        f"the card ran the bind-join kernels for "
        f"{1e3 * kernel_device_s:.3f} ms in {len(joins)} launches "
        "(torch.profiler)")
    log(f"sim: {len(traces)} traces ({truncated} cut at {REQUEST_BUDGET} "
        f"requests), live replay by {SIM_CLIENTS} clients "
        f"through a {SIM_WINDOW_S * 1e3:.0f} ms window: launches simulated "
        f"{lv.simulated_launches} / observed {lv.observed_launches} "
        f"(|rel err| {lv.within:.3f}), skipped {lv.simulated_skipped} / "
        f"{lv.observed_skipped}, cand_streamed {lv.simulated_cand} / "
        f"{lv.observed_cand}, cand_rows {lv.simulated_cand_rows} / "
        f"{lv.observed_cand_rows}, fused {lv.simulated_fused} / "
        f"{lv.observed_fused}, shed {lv.observed_shed}; {secs:.1f}s; "
        f"launches {launched}")
    if lv.within > MAX_SIM_DISAGREEMENT or lv.observed_shed:
        raise SmokeFailure(f"sim: live launches {lv.observed_launches} vs "
                           f"simulated {lv.simulated_launches} "
                           f"(|rel err| {lv.within:.3f} > "
                           f"{MAX_SIM_DISAGREEMENT}) or shed "
                           f"{lv.observed_shed}")
    return out


def model_kernel_s(sim, traces, params):
    """What sim.simulate charges for the traces' kernel-path requests
    served one at a time (a launch overhead per ``launches`` entry, the
    streamed rows, and a cell per streamed row and padded pattern
    slot), and how many such requests there are."""
    out, requests = dict(overhead=0.0, stream=0.0, cells=0.0), 0
    for ev in (e for t in traces for e in t.events):
        if isinstance(ev, sim.HttpRecord) and ev.cand > 0:
            n = max(ev.launches, 1)
            out["overhead"] += n * params.kernel_launch_overhead_s
            out["stream"] += ev.cand * params.kernel_stream_s
            out["cells"] += ev.cand * ev.pats * params.kernel_cell_s / n
            requests += 1
    return out, requests


def device_events(torch, prof):
    """(short name, ns) of each device event of a torch.profiler run.
    The raw trace events are read directly: building the profiler's
    event tree for the sharded run's million events would take
    minutes."""
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            name = ev.name().replace("(anonymous namespace)::", "")
            yield re.split(r"[(<]", name)[0].strip()[-48:], ev.duration_ns()


def profile_sync(torch, core, store, cfg, queries):
    """Device busy share of the sequential client's run: the summed
    span of every device event (kernels, copies, fills) recorded by
    ``torch.profiler`` (device activity only) over the host wall time,
    plus the top device events by total time."""
    from torch.profiler import ProfilerActivity, profile
    server = core.BrTPFServer(store, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, bgp in queries:
            core.BrTPFClient(server, request_budget=REQUEST_BUDGET) \
                .execute(bgp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for name, ns in device_events(torch, prof):
        by_name[name] = by_name.get(name, 0.0) + ns / 1e6
    busy = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                requests=server.counters.num_requests, top=top)


# Which kernels each counted path must launch (the grouped paths run
# tpf_match's test in the grouped kernel's prologue: no tpf_match launch).
PATH_KERNELS = {
    "kernel backend": ("bindjoin_grouped", "bindjoin_fused"),
    "sharded backend": ("bindjoin_grouped", "bindjoin_fused"),
    "execute_full": ("tpf_match", "bindjoin"),
    "edge": ("bindjoin_grouped",),
    "sim": ("bindjoin_grouped",),
}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import core
    from repro_torch.data import watdiv
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    bj = importlib.import_module("repro_torch.kernels.bindjoin")
    tm = importlib.import_module("repro_torch.kernels.tpf_match")

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: torch={kind} count={torch.cuda.device_count()}")
    log(smi)

    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(reports)} sources compiled in {build_s:.1f}s")
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # The store is generated first: phase 3 times the ungrouped kernel
    # at the sharded store's full-stream shape.
    ends = {"build": time.perf_counter() - t_start}
    data, generate_s = generate_data(watdiv)
    ends["data"] = time.perf_counter() - t_start
    kernels, single_window = check_kernels(
        torch, bj, tm, ops, SHARDS * -(-len(data.store) // SHARDS))
    ends["kernels"] = time.perf_counter() - t_start

    wrappers = {"tpf_match": tm.tpf_match_cuda,
                "bindjoin_grouped": bj.bindjoin_grouped_cuda,
                "bindjoin_fused": bj.bindjoin_fused_cuda,
                "bindjoin": bj.bindjoin_cuda}

    # launch geometries per main path, from the wrappers' tallies
    shapes_per_path = {p: {n: Counter() for n in wrappers}
                       for p in PATH_KERNELS}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
            fn.shapes.clear()

    def counts(path):
        for name, fn in wrappers.items():
            shapes_per_path[path][name].update(fn.shapes)
        return {name: fn.launches for name, fn in wrappers.items()}

    queries = pick_queries(watdiv, data)
    log("slice queries: " + " ".join(n for n, _ in queries))
    details, nres = run_slice(torch, core, data, queries, counts,
                              reset_counts)
    ends["slice"] = time.perf_counter() - t_start
    details.update(triples=len(data.store), terms=len(data.dictionary),
                   generate_s=generate_s)
    sharded = run_sharded(torch, core, data, queries, nres, counts,
                          reset_counts)
    ends["sharded"] = time.perf_counter() - t_start
    edge = run_edge(torch, core, data, queries, nres, counts, reset_counts)
    ends["edge"] = time.perf_counter() - t_start
    simulated = run_sim(torch, core, data, queries, counts, reset_counts)
    ends["sim"] = time.perf_counter() - t_start
    details["phase_end_s"] = ends
    details["sharded"] = sharded
    details["edge"] = edge
    details["sim"] = simulated
    per_path = {
        "kernel backend": details["launches"],
        "sharded backend": {
            k: sum(sharded[run]["launches"][k]
                   for run in ("static", "async", "routed"))
            for k in wrappers},
        "execute_full": sharded["execute_full_launches"],
        "edge": edge["resilient"]["launches"],
        "sim": simulated["launches"]}
    for path, names in PATH_KERNELS.items():
        missing = [n for n in names if not per_path[path][n]]
        if missing:
            raise SmokeFailure(f"{missing} never launched on the {path} "
                               f"path: {per_path[path]}")
        if "tpf_match" not in names and per_path[path]["tpf_match"]:
            raise SmokeFailure(f"tpf_match launched on the {path} path: "
                               f"{per_path[path]}")
    records = {"kernel backend": details["launch_records"],
               "sharded backend": sum(sharded[run]["launch_records"]
                                      for run in ("static", "async",
                                                  "routed")),
               "edge": edge["resilient"]["launch_records"]}
    for path, n in records.items():
        log(f"{path}: CUDA launches per LaunchRecord "
            + ", ".join(f"{k} {per_path[path][k] / max(n, 1):.4f}"
                        for k in wrappers) + f" ({n} LaunchRecords)")
    launches = {k: sum(c[k] for c in per_path.values()) for k in wrappers}
    details["launches_per_path"] = per_path
    log(f"kernels launched on the main paths: {per_path}")

    # Not part of the counted main paths: each kernel at the geometries
    # the paths gave it.
    at_paths, largest_chunk = check_path_geometries(torch, bj, tm, ops,
                                                    shapes_per_path)
    ends["path_kernels"] = time.perf_counter() - t_start
    log("phases end at (s): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in ends.items()))
    excess = {k: sum(p["excess_ms"] for p in at_paths[k].values())
              for k in wrappers}
    log("launches x (ms - bound) over the main paths (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    sorted(excess.items(), key=lambda kv: -kv[1])))

    sources = {"tpf_match": "src/repro_torch/kernels/csrc/tpf_match.cu",
               "bindjoin_grouped": "src/repro_torch/kernels/csrc/bindjoin.cu",
               "bindjoin_fused": "src/repro_torch/kernels/csrc/bindjoin.cu",
               "bindjoin": "src/repro_torch/kernels/csrc/bindjoin.cu"}
    replaces = {"tpf_match": "src/repro/kernels/tpf_match.py:44",
                "bindjoin_grouped": "src/repro/kernels/bindjoin.py:192",
                "bindjoin_fused": "src/repro/kernels/bindjoin.py:305",
                "bindjoin": "src/repro/kernels/bindjoin.py:102"}
    # Each kernel's times are those at the geometry launched most on
    # the path that launched it most; "paths" pairs every path's
    # launches with the times at its own geometries, "largest" is
    # phase 3's row.
    entries = []
    for name, big in kernels.items():
        paths = at_paths[name]
        top = max(paths, key=lambda p: paths[p]["launches"])
        r = paths[top]["geometries"][0]
        entries.append(dict(
            name=name, route="cuda", source=sources[name],
            replaces=replaces[name], launches=launches[name],
            max_abs_err=max([big["max_abs_err"]] + [
                g["max_abs_err"] for p in paths.values()
                for g in p["geometries"]]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, path=top,
            shape=r["shape"], excess_ms=excess[name],
            paths={p: dict(launches=v["launches"], geometries=[
                dict(shape=g["shape"], launches=g["launches"], ms=g["ms"],
                     plain_ms=g["plain_ms"], bound_ms=g["bound_ms"])
                for g in v["geometries"]]) for p, v in paths.items()},
            largest={k: big[k] for k in ("shape", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}))
        if name == "bindjoin_fused":
            entries[-1]["largest_chunk"] = {
                k: largest_chunk[k] for k in ("shape", "launches", "ms",
                                              "plain_ms", "bound_ms",
                                              "bound_by")}
    line = {"kernels": entries}

    details.update(device=kind, nvidia_smi=smi, build_s=build_s,
                   kernels=kernels, single_window=single_window,
                   kernels_at_paths=at_paths, largest_chunk=largest_chunk,
                   total_s=time.perf_counter() - t_start)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(details, indent=1, default=str))
    log(f"total: {details['total_s']:.1f}s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
