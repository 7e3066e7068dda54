#!/usr/bin/env python3
"""Drive the PyTorch port's brTPF serving path on one NVIDIA GPU.

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
   on random inputs at the shapes the main path gives it, exact
   equality, with the kernel's and the plain version's times and the
   card's bound for the same work;
4. slice: a WatDiv-like store at 600x the default scale (about 9.25M
   triples, the paper's 10M-triple WatDiv cut only to keep term ids
   under the store's 21-bit packing limit), 8 queries of the L, S, F
   and C families through the sequential brTPF client and through 4
   concurrent async clients on the kernel backend. Solutions and
   fragments must equal the numpy backend's, and each kernel must have
   launched on this path.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. Details go to ``chiprun_out/chip_smoke.json``.
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and INT32 operations
# per second: 64 INT32 lanes per SM (half the 128 FP32 lanes behind the
# 67 TFLOP/s FP32 figure) x 132 SMs x 1.98 GHz boost clock, one
# operation per lane per clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Work per (row, slot) cell of a bind-join: 3 component compares, 2 ANDs,
# 1 add into the count, 1 min into the first index (wildcard and valid
# flags are per slot, not per cell).
OPS_PER_CELL = 7
# Work per row of the single-pattern matcher: 3 component compares and
# 3 repeated-variable compares.
OPS_PER_ROW = 6

SCALE_FACTOR = 600
NUM_QUERIES_PER_FAMILY = 2
REQUEST_BUDGET = 60
ASYNC_CLIENTS = 4


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each after a
    write of 256 MiB so that no input is left in the 50 MB L2 cache."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def max_abs_err(torch, got, want) -> int:
    errs = [int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            if g.numel() else 0 for g, w in zip(got, want, strict=True)]
    return max(errs)


def check_kernels(torch, bj, tm):
    """Phase 3: each kernel against its plain version at main-path
    shapes. Returns per-kernel measurements."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

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

    results = {}

    # tpf_match at the _bucket of the ~2.4M-row `?u likes ?p` range.
    t = 4_194_304
    cand = [randint(0, 4, t) for _ in range(3)]
    pv = torch.tensor([-1, 2, -1, 0, 1, 0, 0, 0], dtype=torch.int32,
                      device=dev)
    got = [tm.tpf_match_cuda(*cand, pv)]
    want = [tm.tpf_match_plain(*cand, pv)]
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    ms = time_ms(torch, lambda: tm.tpf_match_cuda(*cand, pv), 20)
    plain = time_ms(torch, lambda: tm.tpf_match_plain(*cand, pv), 5)
    b, by = bound_ms(16 * t + 32, OPS_PER_ROW * t)
    results["tpf_match"] = dict(shape=dict(T=t), max_abs_err=err, ms=ms,
                                plain_ms=plain, bound_ms=b, bound_by=by,
                                matches=int(want[0].sum()))

    # bindjoin_grouped at the same T, G = 8 groups of Mp = 128 slots.
    g, mp = 8, 128
    cand = [randint(0, 64, t) for _ in range(3)]
    pats = slots(g * mp, 64)
    got = bj.bindjoin_grouped_cuda(*cand, *pats, groups=g)
    want = bj.bindjoin_grouped_plain(*cand, *pats, groups=g)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    ms = time_ms(torch, lambda: bj.bindjoin_grouped_cuda(
        *cand, *pats, groups=g), 10)
    plain = time_ms(torch, lambda: bj.bindjoin_grouped_plain(
        *cand, *pats, groups=g), 2)
    b, by = bound_ms(12 * t + 16 * g * mp + 12 * t * g,
                     OPS_PER_CELL * t * g * mp)
    results["bindjoin_grouped"] = dict(
        shape=dict(T=t, G=g, Mp=mp), max_abs_err=err, ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by,
        kept=int(want[0].sum()))

    # bindjoin_fused at the MAX_FUSED_* ceilings: 131072 rows, 16
    # segments x 2 groups x 1024 slots = 32768 slots.
    t, s, g, mp = 131072, 16, 2, 1024
    cand = [randint(0, 64, t) for _ in range(3)]
    seg = randint(-1, s, t // 256)
    pats = slots(s * g * mp, 64)
    got = bj.bindjoin_fused_cuda(seg, *cand, *pats, segments=s, groups=g)
    want = bj.bindjoin_fused_plain(seg, *cand, *pats, segments=s, groups=g)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    ms = time_ms(torch, lambda: bj.bindjoin_fused_cuda(
        seg, *cand, *pats, segments=s, groups=g), 20)
    plain = time_ms(torch, lambda: bj.bindjoin_fused_plain(
        seg, *cand, *pats, segments=s, groups=g), 2)
    live_rows = int((seg >= 0).sum()) * 256
    b, by = bound_ms(12 * t + 4 * (t // 256) + 16 * s * g * mp + 12 * t * g,
                     OPS_PER_CELL * live_rows * g * mp)
    results["bindjoin_fused"] = dict(
        shape=dict(T=t, S=s, G=g, Mp=mp, live_rows=live_rows),
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
        kept=int(want[0].sum()))

    for name, r in results.items():
        log(f"kernel {name}: {r['shape']} max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            "library_ms=null (no single PyTorch call computes it)")
        if r["max_abs_err"] != 0:
            raise SmokeFailure(f"{name} disagrees with its plain version")
    return results


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


def run_slice(torch, core, watdiv, counts, reset_counts):
    """Phase 4: the serving slice at real scale. Returns details."""
    details = {}
    t0 = time.perf_counter()
    base = watdiv.WatDivScale()
    scale = watdiv.WatDivScale(**{
        f: getattr(base, f) * SCALE_FACTOR
        for f in ("users", "products", "reviews", "retailers", "genres",
                  "cities", "tags")})
    data = watdiv.generate(scale, seed=0)
    details["generate_s"] = time.perf_counter() - t0
    details["triples"] = len(data.store)
    details["terms"] = len(data.dictionary)
    log(f"slice data: {details['triples']} triples, {details['terms']} "
        f"terms, generated in {details['generate_s']:.1f}s")
    queries = pick_queries(watdiv, data)
    log("slice queries: " + " ".join(n for n, _ in queries))

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
    sync_counts = counts()
    t0 = time.perf_counter()
    nres = [core.BrTPFClient(nserver, request_budget=REQUEST_BUDGET)
            .execute(b) for _, b in queries]
    details["sync_numpy_s"] = time.perf_counter() - t0
    per_query = []
    for (name, _), k, n in zip(queries, kres, nres, strict=True):
        if not (k.solutions.shape == n.solutions.shape
                and (k.solutions == n.solutions).all()
                and (k.num_requests, k.data_received, k.timed_out)
                == (n.num_requests, n.data_received, n.timed_out)):
            raise SmokeFailure(f"query {name}: kernel backend differs "
                               "from the numpy backend")
        per_query.append(dict(query=name, solutions=int(k.solutions.shape[0]),
                              requests=k.num_requests,
                              timed_out=k.timed_out))
    details["sync"] = dict(queries=per_query,
                           requests=kserver.counters.num_requests,
                           counters=dataclasses.asdict(kserver.counters),
                           launches=sync_counts)
    log(f"slice sync: {kserver.counters.num_requests} requests, kernel "
        f"{details['sync_kernel_s']:.1f}s, numpy "
        f"{details['sync_numpy_s']:.1f}s, solutions equal; launches "
        f"{sync_counts}")

    # Concurrent async clients over the batching front end: every
    # heterogeneous window goes through the fused kernel.
    aserver = core.BrTPFServer(data.store, kcfg)
    front = RecordingFront(core.AsyncBrTPFServer(aserver))
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

    before = counts()
    t0 = time.perf_counter()
    ares = asyncio.run(drive())
    torch.cuda.synchronize()
    details["async_kernel_s"] = time.perf_counter() - t0
    after = counts()
    async_counts = {k: after[k] - before[k] for k in after}
    oracle = core.BrTPFServer(data.store, core.ServerConfig())
    t0 = time.perf_counter()
    for req, frag in front.log:
        if not same_fragment(frag, oracle.handle(req)):
            raise SmokeFailure(f"async fragment for {req.pattern} page "
                               f"{req.page} differs from the numpy backend")
    details["async_numpy_check_s"] = time.perf_counter() - t0
    for w, results in zip(work, ares, strict=True):
        for i, r in zip(w, results, strict=True):
            n = nres[i]
            if not r.timed_out and not n.timed_out and not (
                    r.solutions.shape == n.solutions.shape
                    and (r.solutions == n.solutions).all()):
                raise SmokeFailure(f"async query {queries[i][0]}: "
                                   "solutions differ")
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
    details["launches"] = counts()

    # Not part of the counted main path: the sequential client once
    # more, on a fresh kernel server, under the profiler.
    details["profile"] = profile_sync(torch, core, data.store, kcfg, queries)
    p = details["profile"]
    log(f"slice profile: sync kernel run {p['wall_s']:.2f}s wall under the "
        f"profiler, device busy {p['device_busy_s']:.3f}s "
        f"({100 * p['busy_share']:.1f}%); top device time (ms): "
        + ", ".join(f"{k} {ms:.1f}" for k, ms in p["top"][:5]))
    return details


def profile_sync(torch, core, store, kcfg, queries):
    """Device busy share of the sequential client's run: the summed
    span of every device event (kernels, copies, fills) recorded by
    ``torch.profiler`` over the host wall time, plus the top device
    events by total time."""
    from torch.profiler import ProfilerActivity, profile
    server = core.BrTPFServer(store, kcfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, bgp in queries:
            core.BrTPFClient(server, request_budget=REQUEST_BUDGET) \
                .execute(bgp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name)[0].strip()[-48:]
            by_name[name] = (by_name.get(name, 0.0)
                             + ev.time_range.elapsed_us())
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_s=wall, device_busy_s=busy, busy_share=busy / wall,
                requests=server.counters.num_requests,
                top=[(name, us / 1e3) for name, us in top])


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

    kernels = check_kernels(torch, bj, tm)

    wrappers = {"tpf_match": tm.tpf_match_cuda,
                "bindjoin_grouped": bj.bindjoin_grouped_cuda,
                "bindjoin_fused": bj.bindjoin_fused_cuda}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    details = run_slice(torch, core, watdiv, counts, reset_counts)
    launches = details["launches"]
    log(f"kernels launched on the main path: {launches} over "
        f"{details['requests']} requests")
    if not all(launches.values()):
        raise SmokeFailure(f"a kernel never launched on the main path: "
                           f"{launches}")

    sources = {"tpf_match": "src/repro_torch/kernels/csrc/tpf_match.cu",
               "bindjoin_grouped": "src/repro_torch/kernels/csrc/bindjoin.cu",
               "bindjoin_fused": "src/repro_torch/kernels/csrc/bindjoin.cu"}
    replaces = {"tpf_match": "src/repro/kernels/tpf_match.py:43",
                "bindjoin_grouped": "src/repro/kernels/bindjoin.py:190",
                "bindjoin_fused": "src/repro/kernels/bindjoin.py:302"}
    line = {"kernels": [dict(
        name=name, route="cuda", source=sources[name],
        replaces=replaces[name], launches=launches[name],
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None)
        for name, r in kernels.items()]}

    details.update(device=kind, nvidia_smi=smi, build_s=build_s,
                   kernels=kernels, total_s=time.perf_counter() - t_start)
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
