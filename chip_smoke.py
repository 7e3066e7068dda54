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
   then analysis: the port's static analyzer (``repro_torch.analysis``)
   over the checkout's ``src/`` and ``benchmarks/`` must report no
   finding, its inventory of CUDA entries (``cuda_entries``) must be
   exactly the four kernel wrappers with their ``.cu`` sources, and
   each entry's C symbol must resolve on the library that was built;
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
   ``calibrate_kernels``, then on the kernel backend and on the sharded
   backend (SHARDS logical shards, as phase 5) ``collect_traces`` of the
   8 queries under ``torch.profiler``: the model's charge for the traces
   (``sim.kernel_charge``: launch overhead, stream, cells; also as the
   JAX package charges the same records), whose summed CUDA launches
   must equal the bind-join launches the profiler saw, and whose stream
   plus cells over the kernels' device time must lie within
   SIM_RATIO_LIMITS; and ``live_replay`` by 4 clients through a 2 ms
   batching window, whose launch count must agree with the model's
   within 10% on the kernel backend (the sharded backend's agreement is
   printed);
6. path kernels (run after 7 and 8): each kernel against its plain
   version again, at the launch geometries each of phases 4, 5, 7 and 8
   gave it most (the wrappers' ``shapes`` tallies), with times and
   bounds beside that path's launches, and the fused kernel at the
   largest chunk the sharded async run launched;
9. lm: the LM serving path (plain torch ops, no hand-written kernel) at
   full width in float32 with TF32 off: ``qwen2-1.5b`` (random
   parameters from ``torch.Generator("cuda").manual_seed(0)``) through
   (a) ``ServingEngine.generate`` at the reference CLI's defaults, (b)
   a stepwise full forward over the growing sequences, (c) a 1 x 4096
   prefill (the chunked-attention branch) and 8 decode steps against
   the full forward, (d) the same parameters on the CPU; then
   ``granite-moe-1b-a400m`` through (a) and (d) with each MoE dispatch.
   Logits must agree within the stated tolerances and tokens wherever
   the top-2 logit gap exceeds them. Prints parameters, peak memory,
   prefill and decode tokens/s and decode ms per step beside the card's
   name and power limit, and each one's bound;
10. train: LM training at ``qwen2-1.5b``'s full width (float32, TF32
   off) through the brTPF data plane: a ``SyntheticCorpus`` of 300
   documents, the train CLI's default selection, batch 4 x 64. (a) the
   ``Trainer`` for 12 steps with a checkpoint every 4 and a failure
   injected before step 9: it must restart once from step 8 and finish,
   its losses equal to an uninterrupted run's; (b) one step at 4 x 2048
   (four CE chunks, remat "full"): ms, tokens/s, peak memory, device
   busy share and the bound; (c) ``grad_accum`` 4 against 1 on one batch
   at the reference test's tolerances; (d) the gradients of the card
   against the CPU at full width cut to 2 layers; (e)
   ``granite-moe-1b-a400m`` at full width, a step per MoE dispatch;
11. families: ``rwkv6-7b`` at full width (the engine at the serve CLI's
   defaults, prefill + 8 decode steps against the forward, card vs CPU
   cut to 2 layers), ``seamless-m4t-medium`` at full width (prefill with
   ``enc_input`` + decode against the forward, a train step, card vs
   CPU) and ``jamba-1.5-large-398b`` at ``reduced_for_smoke`` (card vs
   CPU, a train step), within phase 9's limits;
12. dryrun: the sharding layer and the dry-run launchers
   (``repro_torch.launch.dryrun`` / ``engine_dryrun``) over PyTorch's
   fake process group: (a) rank 0 of the production H100 meshes traced
   on fake CUDA tensors (qwen2-1.5b on gpu32x8 and gpu2x32x8,
   granite-moe-1b-a400m and jamba-1.5-large-398b at full width on
   gpu32x8, each over its shapes, and both engine variants): per-device
   GB, the roofline's compute, memory and collective seconds, the
   collective bytes and counts per mesh dim, and for a train step the
   largest parameter gradient rank 0 holds: no gradient may be held
   above the shard its rules give, and no cell may need more memory per
   device than the card has; (b) the
   engine's distributed step as rank 0 of gpu32x8 for real on the card,
   2^30 / 32 random triples: its local page and count must equal the
   single-card step's and both kernels must launch, with ms and peak
   memory beside the dry-run's; (c) qwen2-1.5b's train_4k and
   prefill_32k steps as rank 0 of gpu32x8 and of gpu2x32x8 and its
   decode_32k step on gpu32x8 for real, peak memory within
   MEM_RATIO_LIMITS of the dry-run's prediction, no parameter gradient
   above its rules' shard, and the dry-run's two-pod GB within
   POD_RATIO_LIMIT of the one-pod GB for every shape traced on both.

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
# Phase 8: the model's stream plus cells (sim.kernel_charge) for the
# traces' kernel-path requests over the bind-join kernels' device time
# while the traces were collected (torch.profiler). Kernel backend:
# within 3x either way. The model's per-row and per-cell costs are those
# of one launch at the chunk cap, where a trace's launches are small:
# each adds a device floor of a few microseconds that the model puts in
# its launch overhead (so the ratio can fall below 1), and its padded
# rows leave the kernel at the prologue (above 1). The JAX package's
# accounting, a cell per padded slot, gave 4.9 on the H100. Sharded
# backend: the model charges a window page the rows of one shard (a
# deployment's shards run in parallel, each on its own device) where the
# card runs all SHARDS logical shards of the page, so its lower limit is
# a third of 1 / SHARDS.
SIM_RATIO_LIMITS = {"kernel": (1 / 3, 3.0),
                    "sharded": (1 / (3 * SHARDS), 3.0)}
# Phase 8: the host calls that issue device work, and the kernel
# launches among them, whose device records the profiler may lose (each
# run prints what it lost); how many times trace collection is profiled
# while the lost launches can explain a shortfall of bind-join records;
# and the seconds the profiler's window spans before and after the work,
# so a device record its clock misplaces by less still falls inside.
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
HOST_ISSUES = HOST_LAUNCHES + ("cudaMemcpy", "cuMemcpy", "cudaMemset",
                               "cuMemset")
PROFILE_ATTEMPTS = 5
PROFILE_MARGIN_S = 0.5
# Phase 9: the LM serving path. (a) runs the reference CLI's defaults
# (launch/serve.py: batch 4, prompts of 4-16 tokens from default_rng(0),
# 24 new tokens, max_seq 64); (c) a prompt above ATTN_CHUNK_THRESHOLD and
# a multiple of ATTN_CHUNK; (d) a prompt the CPU serves in seconds.
LM_MODELS = (("qwen2-1.5b", ("einsum",)),
             ("granite-moe-1b-a400m", ("einsum", "gather")))
LM_BATCH, LM_PROMPT_LEN, LM_NEW_TOKENS, LM_MAX_SEQ = 4, 16, 24, 64
LM_LONG_PROMPT, LM_LONG_DECODE = 4096, 8
LM_CPU_PROMPT, LM_CPU_DECODE = 64, 4
# float32 logits (std about 0.8 at random init) of two paths over the
# same weights: largest absolute difference, and that over the largest
# absolute logit (normwise relative).
LM_ATOL = 1e-3
LM_RTOL = 1e-4
# float32 outside the tensor cores (TF32 off), NVIDIA data sheet.
FP32_FLOPS_PER_S = 67e12
# Phase 10: training at qwen2-1.5b's full width through the brTPF data
# plane. (a) the train CLI's defaults (launch/train.py: 300 documents,
# the default selection, batch 4 x seq 64, warmup_cosine(3e-4, 10,
# steps)) for 12 steps, a checkpoint every 4, a failure injected before
# step 9; (b) one step at 4 x 2048 (four CE chunks); (c) grad_accum 4 vs 1
# on one batch with the reference test's optimizer and tolerances
# (tests/test_loss_and_cli.py: constant lr 1e-2, no decay; rtol 1e-5 on
# the loss, rtol 2e-3 / atol 2e-5 on the parameters); (d) card vs CPU at
# full width cut to 2 layers; (e) granite-moe-1b-a400m, each dispatch.
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SELECTION = "?d hasDomain code\n?d hasQuality q0"
TRAIN_DOCS = 300
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 64, 12
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 4, 9
TRAIN_LONG_SEQ = 2048
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH = 2, 2
# A resumed run replays the batches of its steps from the restored
# state: its losses (about 12 at this vocabulary) equal the
# uninterrupted run's up to the order of the card's atomic additions.
TRAIN_RESUME_ATOL = 1e-3
ACCUM_LR = 1e-2
ACCUM_LOSS_RTOL, ACCUM_RTOL, ACCUM_ATOL = 1e-5, 2e-3, 2e-5
# Adam's first step is lr * g / (|g| + eps): where the two runs'
# gradients of an element agree to ACCUM_DECIDED (relative), the steps
# agree within the tolerances above; elsewhere (a near-cancelling sum at
# float32 noise) the element may move either way, by up to 2 lr.
ACCUM_DECIDED = 1e-3
# (d) and phase 11's gradients: float32 on both sides, the loss within
# GRAD_LOSS_ATOL and each gradient leaf's largest absolute difference
# within GRAD_RTOL of its largest absolute value.
GRAD_LOSS_ATOL, GRAD_RTOL = 1e-4, 1e-4
# Phase 11: the RWKV, encoder-decoder and Mamba-hybrid families.
FAMILY_PROMPT, FAMILY_DECODE = 64, 8
ENC_BATCH, ENC_FRAMES, ENC_PROMPT = 4, 8, 16


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# The .cu source of each kernel, by its name here.
SOURCES = {"tpf_match": "src/repro_torch/kernels/csrc/tpf_match.cu",
           "bindjoin_grouped": "src/repro_torch/kernels/csrc/bindjoin.cu",
           "bindjoin_fused": "src/repro_torch/kernels/csrc/bindjoin.cu",
           "bindjoin": "src/repro_torch/kernels/csrc/bindjoin.cu"}


def kernel_wrappers(bj, tm):
    return {"tpf_match": tm.tpf_match_cuda,
            "bindjoin_grouped": bj.bindjoin_grouped_cuda,
            "bindjoin_fused": bj.bindjoin_fused_cuda,
            "bindjoin": bj.bindjoin_cuda}


def check_analysis(build, wrappers, smi):
    """The port's static analyzer over this checkout, held against the
    kernels this script launches: no finding, the analyzer's CUDA
    entries equal to ``wrappers`` (by function and module) and to
    ``SOURCES`` (by .cu file), and every entry's C symbol present on the
    library ``build.library`` loaded for its source."""
    from repro_torch.analysis import cuda_entries, load_context, run_analysis
    t0 = time.perf_counter()
    ctx = load_context()
    if ctx.root != ROOT:
        raise SmokeFailure(f"analysis: root {ctx.root}, expected {ROOT}")
    findings = run_analysis(ctx)
    if findings:
        raise SmokeFailure(f"analysis: {len(findings)} findings:\n"
                           + "\n".join(f.format() for f in findings))
    entries = cuda_entries(ctx)
    got = {e.function: (e.module.rel, e.source) for e in entries}
    want = {fn.__name__: ("src/" + fn.__module__.replace(".", "/") + ".py",
                          SOURCES[name]) for name, fn in wrappers.items()}
    if len(entries) != len(got) or got != want:
        raise SmokeFailure(f"analysis: CUDA entries {got}, the wrappers "
                           f"launched here {want}")
    missing = [e.symbol for e in entries
               if not hasattr(build.library(Path(e.source).stem), e.symbol)]
    if missing:
        raise SmokeFailure(f"analysis: C symbols not in their library: "
                           f"{missing}")
    seconds = time.perf_counter() - t0
    log(f"analysis: {len(ctx.modules)} modules, 0 findings, "
        f"{len(entries)} CUDA entries equal to the wrappers and their "
        f"sources, every C symbol resolved; {seconds:.2f} s ({smi})")
    return dict(modules=len(ctx.modules), findings=0, seconds=seconds,
                entries={e.function: [e.module.rel, e.symbol, e.source]
                         for e in entries})


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
    inner = (delay_recorder(resilience)(
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
        hedging=hedge_diagnosis(attempts.calls, resilience,
                                getattr(inner, "spans", []),
                                res["hedges"]))
    return out


def delay_recorder(resilience):
    """A ``ResilientTransport`` that keeps, for each ``_attempt``, its
    start, the hedge delay its own ``_hedge_delay_s`` gave it (``None``:
    no hedging yet), its end and whether it succeeded, in ``spans``."""

    class DelayRecorder(resilience.ResilientTransport):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.spans = []

        def _hedge_delay_s(self):
            delay = super()._hedge_delay_s()
            self.spans.append([time.perf_counter(), delay, None, False])
            return delay

        async def _attempt(self, req, remaining_s):
            # the parent's _attempt asks for its delay before its first
            # await, so the span it appends is this attempt's
            n = len(self.spans)
            try:
                frag = await super()._attempt(req, remaining_s)
                self.spans[n][3] = True
                return frag
            finally:
                self.spans[n][2] = time.perf_counter()

    return DelayRecorder


def hedge_diagnosis(calls, resilience, spans, hedges):
    """Why the resilient arm hedged as often as it did. A
    ResilientTransport hedges an attempt still open after the p95 of
    the successful attempts that ended before it began (its last
    LATENCY_WINDOW), once ``hedge_min_samples`` of them exist; an
    attempt is cut at ``attempt_timeout_ms``. Replays that rule over
    the attempts' own spans: for each attempt cut at the timeout, how
    many successes it could see and the hedge delay then in force.
    Beside it, the transport's own record (``delay_recorder``): how many
    of its attempts outlived the delay it computed at their start, that
    delay less the replay's rule at the same moment (the transport
    times an attempt from before its primary task is scheduled, the
    replay from when the call below it starts), and how many hedges it
    fired."""
    policy = resilience.RetryPolicy(**RETRY)
    window = resilience.ResilientTransport.LATENCY_WINDOW
    start = min(t0 for t0, _, _ in calls)
    oks = sorted((t1, t1 - t0) for t0, t1, err in calls if err is None)
    cap_s = policy.attempt_timeout_ms / 1e3

    def delay_at(t):
        """(successes ended by ``t``, the replay's hedge delay then)."""
        seen = [d for end, d in oks if end <= t][-window:]
        if len(seen) < policy.hedge_min_samples:
            return len(seen), None
        ordered = sorted(seen)
        return len(seen), ordered[min(len(ordered) - 1,
                                      int(0.95 * len(ordered)))]

    cut, would_hedge = [], 0
    for t0, t1, err in calls:
        n_seen, delay = delay_at(t0)
        if delay is not None:
            would_hedge += t1 - t0 > delay
        if err is not None and t1 - t0 >= 0.95 * cap_s:
            cut.append(dict(start_s=t0 - start, successes_seen=n_seen,
                            hedge_delay_ms=None if delay is None
                            else 1e3 * delay, error=err))
    reached = (oks[policy.hedge_min_samples - 1][0] - start
               if len(oks) >= policy.hedge_min_samples else None)
    timed = [(t1 - t0, d) for t0, d, t1, _ in spans if d is not None]
    replay = [(d, delay_at(t0)[1]) for t0, d, _, _ in spans]
    gaps = [d - r for d, r in replay if d is not None and r is not None]
    return dict(attempts=len(calls), cut=cut, would_hedge=would_hedge,
                min_samples=policy.hedge_min_samples,
                min_samples_reached_s=reached,
                transport_attempts=len(spans),
                transport_with_delay=len(timed),
                outlived_own_delay=sum(span > d for span, d in timed),
                own_delays_ms=[1e3 * min(d for _, d in timed),
                               1e3 * max(d for _, d in timed)]
                if timed else None,
                delay_gap_ms=[1e3 * min(gaps), 1e3 * max(gaps)]
                if gaps else None,
                delay_presence_differs=sum((d is None) != (r is None)
                                           for d, r in replay),
                hedges=hedges)


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
    log(f"edge hedging, side by side: of the transport's "
        f"{h['transport_attempts']} attempts, {h['transport_with_delay']} "
        f"had a hedge delay (its own, "
        + ("-" if h["own_delays_ms"] is None else
           f"{h['own_delays_ms'][0]:.1f}-{h['own_delays_ms'][1]:.1f} ms")
        + f") and {h['outlived_own_delay']} outlived it; the replay "
        f"would hedge {h['would_hedge']}; the transport hedged "
        f"{h['hedges']}; its delay less the replay's rule at the same "
        f"moment: {h['delay_gap_ms']} ms (min, max), "
        f"{h['delay_presence_differs']} attempts where only one had a "
        "delay")
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
    counted), then a counted path per backend: trace collection under
    torch.profiler and the live replay through the async front end."""
    from repro_torch.core import sim
    t0 = time.perf_counter()
    profile = sim.calibrate_kernels()
    calibrate_s = time.perf_counter() - t0
    log("sim kernel profile (calibrate_kernels): " + ", ".join(
        f"{k} {v:.4e}" for k, v in profile.items())
        + f" ({calibrate_s:.1f}s)")
    kcfg = core.ServerConfig(selector_backend="kernel", fast_path_rows=0)
    params = sim.calibrate(core.BrTPFServer(data.store, kcfg), queries)
    params = dataclasses.replace(params, **profile)
    out = dict(profile=profile, calibrate_s=calibrate_s,
               params=dataclasses.asdict(params))
    for backend, cfg, path in (
            ("kernel", kcfg, "sim"),
            ("sharded", kcfg.replace(selector_backend="sharded",
                                     shards=SHARDS), "sim sharded")):
        reset_counts()
        t0 = time.perf_counter()
        traces, charge = sim_charge(torch, core, sim, data, queries, cfg,
                                    params, backend)
        # A query cut by the request budget leaves a trace of its first
        # REQUEST_BUDGET requests, which the model would skip whole (it
        # replays a trace only if the query completed) while the live
        # front end serves every request of it: both replay the same
        # recorded requests once each trace counts as complete.
        truncated = sum(not t.completed for t in traces)
        traces = [dataclasses.replace(t, completed=True) for t in traces]
        lv = sim.live_replay(sim.split_workload(traces, SIM_CLIENTS),
                             core.BrTPFServer(data.store, cfg), params,
                             batch_window_s=SIM_WINDOW_S)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = counts(path)
        # the raw-row gap: the model's memo keys a fragment's owner by
        # query name, which two queries of one template share
        apart = sim.simulate(sim.split_workload(
            [dataclasses.replace(t, name=f"{t.name}#{i}")
             for i, t in enumerate(traces)], SIM_CLIENTS),
            dataclasses.replace(params, batch_window_s=SIM_WINDOW_S,
                                server_workers=1))
        out[backend] = dict(charge, seconds=secs, launches=launched,
                            within=lv.within, truncated=truncated,
                            live=dataclasses.asdict(lv),
                            cand_rows_named_apart=apart.cand_rows)
        shard = (f", shard pages |rel err| {lv.shard_within:.3f}"
                 if backend == "sharded" else "")
        log(f"sim {backend}: {len(traces)} traces ({truncated} cut at "
            f"{REQUEST_BUDGET} requests), live replay by {SIM_CLIENTS} "
            f"clients through a {SIM_WINDOW_S * 1e3:.0f} ms window: "
            f"launches simulated {lv.simulated_launches} / observed "
            f"{lv.observed_launches} (|rel err| {lv.within:.3f}), skipped "
            f"{lv.simulated_skipped} / {lv.observed_skipped}, "
            f"cand_streamed {lv.simulated_cand} / {lv.observed_cand}, "
            f"cand_rows {lv.simulated_cand_rows} / "
            f"{lv.observed_cand_rows} (simulated with each trace named "
            f"apart {apart.cand_rows}), fused {lv.simulated_fused} / "
            f"{lv.observed_fused}{shard}, shed {lv.observed_shed}; "
            f"{secs:.1f}s; launches {launched}")
        if lv.observed_shed or (backend == "kernel"
                                and lv.within > MAX_SIM_DISAGREEMENT):
            raise SmokeFailure(
                f"sim {backend}: live launches {lv.observed_launches} vs "
                f"simulated {lv.simulated_launches} (|rel err| "
                f"{lv.within:.3f} > {MAX_SIM_DISAGREEMENT}) or shed "
                f"{lv.observed_shed}")
    return out


def sim_charge(torch, core, sim, data, queries, cfg, params, backend):
    """``collect_traces`` of the queries on one backend under
    torch.profiler: the model's charge for the traces beside the
    bind-join kernels' profiled launches and device time. Fails unless
    the traces' CUDA launches equal the profiled launches and the
    model's stream plus cells over the device time lies within
    SIM_RATIO_LIMITS. A profile short of the traces' launches by no more
    than the kernel launches it lost (``lost_device_records``) is taken
    again on a fresh server, up to PROFILE_ATTEMPTS times in all.
    Returns the traces and the numbers."""
    from torch.profiler import ProfilerActivity, profile as profiler
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        server = core.BrTPFServer(data.store, cfg)
        torch.cuda.synchronize()
        with profiler(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            traces = sim.collect_traces(server, queries, "brtpf",
                                        request_budget=REQUEST_BUDGET)
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        recs = [e for t in traces for e in t.events
                if isinstance(e, sim.HttpRecord) and e.cand > 0]
        cuda_launches = sum(e.cuda_launches for e in recs)
        joins = [ns for name, ns in device_events(torch, prof)
                 if "bindjoin" in name]
        lost = lost_device_records(torch, prof)
        if not 0 < cuda_launches - len(joins) <= lost["launches"]:
            break
        log(f"sim {backend} backend, profile {attempt} of trace collection: "
            f"{len(joins)} bind-join device records for the traces' "
            f"{cuda_launches} launches, and {profile_losses(lost)}; "
            "collected again")
    device_s = sum(joins) / 1e9
    model, requests = model_kernel_s(sim, traces, params)
    records = sum(e.launches for e in recs)
    ratio = {k: (m["stream"] + m["cells"]) / max(device_s, 1e-12)
             for k, m in model.items()}
    lo, hi = SIM_RATIO_LIMITS[backend]

    def ms(m):
        return (f"{1e3 * sum(m.values()):.3f} ms (overhead "
                f"{1e3 * m['overhead']:.3f}, stream {1e3 * m['stream']:.3f},"
                f" cells {1e3 * m['cells']:.3f})")

    log(f"sim {backend} backend, kernel time of trace collection: the "
        "model charges "
        f"{ms(model['cuda'])} for {requests} kernel-path requests "
        f"({records} LaunchRecords, {cuda_launches} CUDA launches in the "
        f"traces); the card ran the bind-join kernels for "
        f"{1e3 * device_s:.3f} ms in {len(joins)} launches "
        f"(torch.profiler, attempt {attempt}: {profile_losses(lost)}); "
        f"stream + cells / device time {ratio['cuda']:.3f}"
        f" (limits {lo:.3f}-{hi:.3f}); the JAX package's accounting of "
        f"the same records: {ms(model['jax'])}, ratio {ratio['jax']:.3f}")
    if cuda_launches != len(joins):
        raise SmokeFailure(f"sim {backend}: the traces carry {cuda_launches} "
                           f"CUDA launches, the profiler saw {len(joins)} "
                           f"bind-join launches ({profile_losses(lost)})")
    if not lo <= ratio["cuda"] <= hi:
        raise SmokeFailure(f"sim {backend}: the model's stream + cells over "
                           f"the kernels' device time is {ratio['cuda']:.3f}"
                           f", outside {lo:.3f}-{hi:.3f}")
    return traces, dict(profile_attempts=attempt, profile_losses=lost,
                        requests=requests, launch_records=records,
                        cuda_launches=cuda_launches,
                        collect_launches=len(joins),
                        kernel_device_s=device_s, model_kernel_s=model,
                        ratio=ratio)


def model_kernel_s(sim, traces, params):
    """What ``sim.simulate`` charges the traces' kernel-path requests
    served one at a time, through ``sim.kernel_charge`` (its marginal
    without the request overhead is the cells): as the records give it
    (``cuda``) and as the JAX package charges the same records, their
    CUDA fields zeroed (``jax``); and how many such requests there are."""
    cells_only = dataclasses.replace(params, req_overhead_s=0.0)
    out = {k: dict(overhead=0.0, stream=0.0, cells=0.0)
           for k in ("cuda", "jax")}
    requests = 0
    for ev in (e for t in traces for e in t.events):
        if isinstance(ev, sim.HttpRecord) and ev.cand > 0:
            requests += 1
            for k, rec in (("cuda", ev), ("jax", dataclasses.replace(
                    ev, live_slots=0, cuda_launches=0))):
                for name, sec in zip(("overhead", "stream", "cells"),
                                     sim.kernel_charge(rec, cells_only),
                                     strict=True):
                    out[k][name] += sec
    return out, requests


def lost_device_records(torch, prof):
    """What a torch.profiler run lost: the ``HOST_ISSUES`` calls it
    recorded on the host without a device record, by name (``calls``);
    how many of them were kernel launches (``launches``), of how many it
    recorded (``of``), and the place of each such launch counted from the
    last (``from_end``); and the most ms by which its clock put a device
    record before the call that issued it (``early_ms``). The profiler
    matches the two by correlation id and keeps only device records
    whose time falls inside its window; its conversion of the device
    clock can be off (by seconds on a loaded host: kineto's "CPU GPU
    out-of-order" and "Out-of-range" record counts), and the records it
    drops are missing from ``device_events``."""
    device, host = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device[ev.correlation_id()] = ev.start_ns()
        elif ev.name().startswith(HOST_ISSUES):
            host.append((ev.start_ns(), ev.name(), ev.correlation_id()))
    host.sort()
    launches = [c for _, name, c in host if name.startswith(HOST_LAUNCHES)]
    early = [t - device[c] for t, _, c in host if c in device]
    from_end = [len(launches) - i for i, c in enumerate(launches)
                if c not in device]
    return dict(calls=dict(Counter(name for _, name, c in host
                                   if c not in device)),
                launches=len(from_end), of=len(launches),
                from_end=from_end, early_ms=max([0, *early]) / 1e6)


def profile_losses(lost):
    return (f"{lost['launches']} of its {lost['of']} kernel launches "
            f"without a device record, at {lost['from_end']} from the "
            f"last; host calls without one {lost['calls']}; device records "
            f"up to {lost['early_ms']:.3f} ms before their calls")


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


def lm_padded(prompts):
    """Prompts left-padded with 0 to a common length, as the engine
    pads them."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return toks


def lm_path(torch, model, toks, feed, max_seq, enc_input=None):
    """The logits a greedy engine computes along ``feed``: prefill of
    ``toks`` [B, P], then one decode step per token of ``feed`` [B, N]
    (an encoder-decoder with ``enc_input`` [B, F, d], a host array).
    Returns (logits [B, N + 1, V], prefill seconds, each decode step's
    seconds), each time on the host clock up to a synchronise."""
    dev = model.norm_f.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    enc = enc_out = None
    if enc_input is not None:
        enc = torch.as_tensor(enc_input, device=dev)
        enc_out = model.encode(enc)
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill(torch.as_tensor(toks, device=dev), enc,
                                  max_seq=max_seq)
    sync()
    prefill_s = time.perf_counter() - t0
    out, steps = [logits[:, 0]], []
    for j in range(feed.shape[1]):
        tok = torch.as_tensor(feed[:, j:j + 1], device=dev)
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok, toks.shape[1] + j,
                                          enc_out=enc_out)
        sync()
        steps.append(time.perf_counter() - t0)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), prefill_s, steps


def lm_profile_decode(torch, model, toks, feed, max_seq):
    """One decode step at the engine's batch, after a warm one, under
    ``torch.profiler``: the device time of its kernels and copies, how
    many there were, and the host ops that took the most CPU time."""
    from torch.profiler import ProfilerActivity, profile
    dev = model.norm_f.device
    _, cache = model.prefill(torch.as_tensor(toks, device=dev),
                             max_seq=max_seq)
    plen = toks.shape[1]
    tok = [torch.as_tensor(feed[:, j:j + 1], device=dev) for j in (0, 1)]
    model.decode_step(cache, tok[0], plen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(cache, tok[1], plen + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(device_events(torch, prof))
    by_name = Counter()
    for name, ns in events:
        by_name[name] += ns / 1e6
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    return dict(
        profiled_wall_s=wall, device_events=len(events),
        device_s=sum(ns for _, ns in events) / 1e9,
        top_device=by_name.most_common(4),
        top_host=[(e.key, e.count, e.self_cpu_time_total / 1e3)
                  for e in ops])


def lm_logits_close(torch, label, got, want):
    """Logits [B, N, V] of two paths: the largest absolute difference
    within LM_ATOL, and that over the largest absolute logit within
    LM_RTOL."""
    want = want.to(got.device)
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        raise SmokeFailure(f"lm {label}: non-finite logits")
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    log(f"lm {label}: logits {tuple(got.shape)} max_abs_err {err:.3e} "
        f"(atol {LM_ATOL:g}), max_rel_err {rel:.3e} (rtol {LM_RTOL:g})")
    if err > LM_ATOL or rel > LM_RTOL:
        raise SmokeFailure(f"lm {label}: logits disagree ({err}, {rel})")
    return dict(max_abs_err=err, max_rel_err=rel)


def lm_tokens_agree(torch, label, logits, tokens):
    """``tokens`` [B, N] must be the argmax of ``logits`` [B, N, V]
    wherever its top-2 gap exceeds LM_ATOL (a nearer tie may break
    either way between two paths)."""
    top = logits.float().topk(2, dim=-1)
    decided = (top.values[..., 0] - top.values[..., 1]) > LM_ATOL
    tokens = torch.as_tensor(tokens, device=logits.device)
    wrong = int(((top.indices[..., 0] != tokens) & decided).sum())
    log(f"lm {label}: tokens equal at {int(decided.sum()) - wrong} of "
        f"{int(decided.sum())} steps whose top-2 gap > {LM_ATOL:g} "
        f"({decided.numel()} steps)")
    if wrong:
        raise SmokeFailure(f"lm {label}: {wrong} tokens differ")
    return dict(decided=int(decided.sum()), steps=decided.numel())


def lm_bounds(cfg, param_bytes, batch, prompt, max_seq):
    """The least card time (ms) of a prefill of batch x prompt tokens and
    of one decode step at ``batch`` with a ``max_seq`` cache: the larger
    of bytes over the HBM rate (every parameter read once; the decode
    step also reads the K/V cache) and float32 operations over the FP32
    peak (2 per multiply-add of the routed experts' and the other
    layers' weights, the full score matrix and its product with V as the
    reference computes them, and the head on the rows unembedded)."""
    d, v = cfg.d_model, cfg.vocab_size
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    per_token = 2 * (cfg.active_param_count() - embed)
    attn = 4 * cfg.num_heads * cfg.resolved_head_dim * cfg.num_layers
    head = 2 * v * d
    kv = (2 * 4 * cfg.num_layers * batch * max_seq * cfg.num_kv_heads
          * cfg.resolved_head_dim)

    def bound(flops, nbytes):
        return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3

    return (bound(batch * (prompt * per_token + head
                           + attn * prompt * prompt), param_bytes),
            bound(batch * (per_token + head + attn * max_seq),
                  param_bytes + kv))


def lm_engine(torch, model, label, res):
    """(a): ``ServingEngine.generate`` at the reference serve CLI's
    defaults; its tokens must be the argmax of its own prefill/decode
    path's logits wherever the top-2 gap exceeds LM_ATOL. Records
    generate, prefill and mean decode-step seconds in ``res``; returns
    (padded prompts, generated tokens, the path's logits)."""
    from repro_torch.serving.engine import ServingEngine
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=rng.integers(4, LM_PROMPT_LEN + 1))
               .astype(np.int32) for _ in range(LM_BATCH)]
    engine = ServingEngine(model, max_batch=LM_BATCH, max_seq=LM_MAX_SEQ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=LM_NEW_TOKENS)
    res["generate_s"] = time.perf_counter() - t0
    gen = np.stack([r.tokens for r in results]).astype(np.int64)
    if (gen.shape != (LM_BATCH, LM_NEW_TOKENS)
            or any(r.steps != LM_NEW_TOKENS for r in results)
            or gen.min() < 0 or gen.max() >= cfg.vocab_size):
        raise SmokeFailure(f"lm {label}: engine gave {gen.shape} tokens, "
                           f"steps {[r.steps for r in results]}")
    toks = lm_padded(prompts)
    path, res["prefill_s"], steps = lm_path(torch, model, toks,
                                            gen[:, :-1], LM_MAX_SEQ)
    res["decode_step_s"] = float(np.mean(steps))
    log(f"lm {label} (a): generate batch {LM_BATCH}, prompts "
        f"{sorted(len(p) for p in prompts)}, {LM_NEW_TOKENS} new tokens "
        f"in {res['generate_s']:.3f} s; req0 {gen[0, :8].tolist()}...")
    res["a"] = lm_tokens_agree(torch, f"{label} (a) engine tokens vs the "
                               "logits of its prefill/decode path", path,
                               gen)
    return toks, gen, path


def lm_card_vs_cpu(torch, model, label, tokens, res, enc_input=None):
    """(d): the prefill/decode path over ``tokens`` [B, P + LM_CPU_DECODE]
    on the card, then the same model moved to the CPU; logits within the
    limits, tokens where decided. Records seconds in ``res``."""
    args = (tokens[:, :-LM_CPU_DECODE], tokens[:, -LM_CPU_DECODE:],
            tokens.shape[1])
    card = lm_path(torch, model, *args, enc_input=enc_input)[0].cpu()
    t0 = time.perf_counter()
    model.to("cpu")
    torch.cuda.empty_cache()
    res["to_cpu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = lm_path(torch, model, *args, enc_input=enc_input)[0]
    res["cpu_s"] = time.perf_counter() - t0
    res["d"] = lm_logits_close(
        torch, f"{label} (d) card vs CPU, prefill {args[0].shape[0]}x"
        f"{args[0].shape[1]} + {LM_CPU_DECODE} decode", card, host)
    res["d"].update(lm_tokens_agree(torch, f"{label} (d)", host,
                                    card.argmax(-1)))


def lm_model(torch, arch, dispatch, smi, full_checks):
    """Phase 9 for one model and MoE dispatch: (a) and (d), and with
    ``full_checks`` (b) and (c); returns its numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model

    t_start = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch), moe_dispatch=dispatch)
    label = f"{arch} {dispatch}" if cfg.moe else arch
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    nparams = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"lm {label}: {nparams:,} parameters ({nbytes / 1e9:.2f} GB "
        f"float32), allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} | {smi}")
    res = dict(params=nparams, param_bytes=nbytes)

    # (a) the engine at the reference CLI's defaults
    toks, gen, path = lm_engine(torch, model, label, res)
    prof = lm_profile_decode(torch, model, toks, gen, LM_MAX_SEQ)
    res["decode_profile"] = prof
    log(f"lm {label} decode profile: {prof['device_events']} device "
        f"events, {prof['device_s'] * 1e3:.2f} ms of device time in one "
        f"step (unprofiled step {res['decode_step_s'] * 1e3:.2f} ms, "
        f"profiled {prof['profiled_wall_s'] * 1e3:.2f} ms); device: "
        + ", ".join(f"{n} {ms:.3f} ms" for n, ms in prof["top_device"])
        + "; host self CPU: "
        + ", ".join(f"{k} x{c} {ms:.2f} ms" for k, c, ms in
                    prof["top_host"]))

    rng = np.random.default_rng(1)
    long = rng.integers(1, cfg.vocab_size,
                        size=(1, LM_LONG_PROMPT + LM_LONG_DECODE))
    if full_checks:
        # (b) the engine's path against a stepwise full forward
        fwd = torch.stack([
            model(torch.as_tensor(np.concatenate([toks, gen[:, :j]], 1),
                                  device="cuda"))[0][:, -1]
            for j in range(LM_NEW_TOKENS)], dim=1)
        res["b"] = lm_logits_close(torch, f"{label} (b) engine path vs "
                                   "stepwise forward", path, fwd)
        res["b"].update(lm_tokens_agree(torch, f"{label} (b) engine tokens "
                                        "vs stepwise forward", fwd, gen))
        del fwd
        # (c) the chunked-attention prefill and decode vs the forward
        lpath, res["long_prefill_s"], _ = lm_path(
            torch, model, long[:, :LM_LONG_PROMPT],
            long[:, LM_LONG_PROMPT:], long.shape[1])
        full = model(torch.as_tensor(long, device="cuda"))[0][
            :, LM_LONG_PROMPT - 1:]
        res["c"] = lm_logits_close(
            torch, f"{label} (c) prefill 1x{LM_LONG_PROMPT} (chunked) + "
            f"{LM_LONG_DECODE} decode vs forward 1x{long.shape[1]}",
            lpath, full)
        res["c"].update(lm_tokens_agree(torch, f"{label} (c)", full,
                                        lpath.argmax(-1)))
        del full, lpath
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(torch.as_tensor(long[:, :LM_LONG_PROMPT],
                                      device="cuda"))
        torch.cuda.synchronize()
        res["long_prefill_s"] = time.perf_counter() - t0
    res["peak_bytes"] = torch.cuda.max_memory_allocated()

    # (d) the same parameters on the CPU
    short = rng.integers(1, cfg.vocab_size,
                         size=(1, LM_CPU_PROMPT + LM_CPU_DECODE))
    lm_card_vs_cpu(torch, model, label, short, res)
    del model

    plen = toks.shape[1]
    b_long, _ = lm_bounds(cfg, nbytes, 1, LM_LONG_PROMPT, LM_LONG_PROMPT)
    b_prefill, b_decode = lm_bounds(cfg, nbytes, LM_BATCH, plen, LM_MAX_SEQ)
    res.update(bound_long_prefill_ms=b_long, bound_prefill_ms=b_prefill,
               bound_decode_ms=b_decode,
               seconds=time.perf_counter() - t_start)
    log(f"lm {label} numbers | {smi}: "
        f"prefill 1x{LM_LONG_PROMPT} "
        f"{LM_LONG_PROMPT / res['long_prefill_s']:.0f} tok/s "
        f"({res['long_prefill_s'] * 1e3:.1f} ms, bound {b_long:.1f} ms); "
        f"prefill {LM_BATCH}x{plen} "
        f"{LM_BATCH * plen / res['prefill_s']:.0f} tok/s "
        f"({res['prefill_s'] * 1e3:.2f} ms, bound {b_prefill:.3f} ms); "
        f"decode batch {LM_BATCH} {res['decode_step_s'] * 1e3:.2f} ms/step "
        f"= {LM_BATCH / res['decode_step_s']:.0f} tok/s (bound "
        f"{b_decode:.3f} ms/step); engine "
        f"{LM_BATCH * LM_NEW_TOKENS / res['generate_s']:.0f} tok/s; peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB; CPU side {res['cpu_s']:.1f} s "
        f"after a {res['to_cpu_s']:.1f} s move; {res['seconds']:.1f} s")
    return res


def run_lm(torch, smi):
    """Phase 9: the LM serving path at full width, float32, TF32 off."""
    from repro_torch.models import layers
    if not (LM_LONG_PROMPT > layers.ATTN_CHUNK_THRESHOLD
            and LM_LONG_PROMPT % layers.ATTN_CHUNK == 0):
        raise SmokeFailure("lm: (c) would not take the chunked branch")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    out = {}
    with torch.inference_mode():
        for i, (arch, dispatches) in enumerate(LM_MODELS):
            for dispatch in dispatches:
                out[f"{arch} {dispatch}"] = lm_model(torch, arch, dispatch,
                                                     smi, i == 0)
    out["seconds"] = time.perf_counter() - t0
    log(f"lm: phase took {out['seconds']:.1f} s")
    return out


# -- phase 10: training ---------------------------------------------------------

def train_tensors(torch, batch, device="cuda"):
    return {k: torch.as_tensor(np.asarray(v, np.int64), device=device)
            for k, v in batch.items()}


def finite(torch, tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def grads_close(torch, label, got, want):
    """Two grad steps' (grads, metrics): the loss within GRAD_LOSS_ATOL,
    the global norm and every leaf within GRAD_RTOL (normwise)."""
    from repro_torch.train.optimizer import global_norm
    loss_err = abs(float(got[1]["loss"]) - float(want[1]["loss"]))
    worst, worst_name = 0.0, None
    for name, w in want[0].items():
        g = got[0][name].to(w.device)
        rel = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    n_got, n_want = float(global_norm(got[0])), float(global_norm(want[0]))
    norm_rel = abs(n_got - n_want) / n_want
    log(f"{label}: loss {float(want[1]['loss']):.6f} err {loss_err:.3e} "
        f"(atol {GRAD_LOSS_ATOL:g}); grad norm {n_want:.6f} rel err "
        f"{norm_rel:.3e}; worst of {len(want[0])} leaves {worst:.3e} "
        f"({worst_name}) (rtol {GRAD_RTOL:g})")
    if not (finite(torch, got[0].values()) and finite(torch,
                                                       want[0].values())):
        raise SmokeFailure(f"{label}: non-finite gradients")
    if loss_err > GRAD_LOSS_ATOL or worst > GRAD_RTOL or norm_rel > GRAD_RTOL:
        raise SmokeFailure(f"{label}: gradients disagree")
    return dict(loss=float(want[1]["loss"]), loss_err=loss_err,
                grad_norm=n_want, norm_rel_err=norm_rel, worst_leaf=worst,
                worst_name=worst_name)


def grad_card_vs_cpu(torch, card, batch, label):
    """One grad step of ``card`` (a model on the card) and of its copy on
    the CPU over ``batch`` (host arrays)."""
    import copy
    from repro_torch.launch.steps import make_grad_step
    host = copy.deepcopy(card).to("cpu")
    got = make_grad_step(card)(dict(card.named_parameters()),
                               {k: torch.as_tensor(v, device="cuda")
                                for k, v in batch.items()})
    t0 = time.perf_counter()
    want = make_grad_step(host)(dict(host.named_parameters()),
                                {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
    out = grads_close(torch, label, got, want)
    out["cpu_s"] = time.perf_counter() - t0
    return out


def timed_steps(torch, step_fn, params, opt_state, batch, n):
    """``n`` train steps on one batch; returns (state, metrics, each
    step's seconds up to a synchronise)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return params, opt_state, metrics, times


def train_run(torch, cfg, batches, ckpt_dir, ckpt_every, fail_at, io):
    """(a): the train CLI's loop for TRAIN_STEPS steps; the batch of
    each step is the one of the step it is, so a run that restores a
    checkpoint replays the batches of the steps it replays. With
    ``fail_at``, the failure hook raises once before that step."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import AdamW, warmup_cosine

    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(3e-4, 10, TRAIN_STEPS))
    step_fn = make_train_step(model, opt)
    steps = []

    def timed(params, opt_state, batch):
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return out

    fired = []

    def hook(step):
        if step == fail_at and not fired:
            fired.append(step)
            raise RuntimeError(f"injected failure before step {step}")

    trainer = Trainer(TrainerConfig(total_steps=TRAIN_STEPS,
                                    ckpt_dir=ckpt_dir,
                                    ckpt_every=ckpt_every, ckpt_keep=1),
                      timed, params, opt.init(params), failure_hook=hook)
    feed = (batches[trainer.step] for _ in iter(int, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = trainer.train(feed)
    wall = time.perf_counter() - t0
    return model, trainer, report, dict(wall_s=wall, step_s=steps,
                                        saves=list(io["save"]),
                                        restores=list(io["restore"]))


def train_resume(torch, cfg, pipe, res):
    """(a): an uninterrupted run and a run that fails before step
    TRAIN_FAIL_AT, resumes from its step-8 checkpoint and finishes; the
    losses of the same steps agree within TRAIN_RESUME_ATOL. Returns the
    resumed run's model and trainer."""
    import shutil
    import tempfile
    ck = importlib.import_module("repro_torch.train.checkpoint")
    it = iter(pipe)
    batches = [train_tensors(torch, next(it)) for _ in range(TRAIN_STEPS)]
    io = {"save": [], "restore": []}
    save, restore = ck.save, ck.restore

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            io[name].append(time.perf_counter() - t0)
            return out
        return call

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                dir=ROOT / "build")
    ck.save, ck.restore = timed("save", save), timed("restore", restore)
    try:
        model, _, plain, plain_io = train_run(
            torch, cfg, batches, ckpt_dir + "/plain", TRAIN_STEPS + 1,
            None, io)
        del model
        torch.cuda.empty_cache()
        io["save"].clear()
        model, trainer, resumed, resumed_io = train_run(
            torch, cfg, batches, ckpt_dir + "/resumed", TRAIN_CKPT_EVERY,
            TRAIN_FAIL_AT, io)
        free = shutil.disk_usage(ckpt_dir).free
    finally:
        ck.save, ck.restore = save, restore
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in importlib.import_module(
                          "repro_torch.train.tree").leaves(
                              trainer._state_tree()))
    # the resumed run: steps 0..FAIL_AT-1, then from the restored step
    back = TRAIN_FAIL_AT - (TRAIN_FAIL_AT % TRAIN_CKPT_EVERY)
    want = plain.losses[:TRAIN_FAIL_AT] + plain.losses[back:]
    err = max(abs(a - b) for a, b in zip(resumed.losses, want))
    ok = (resumed.restarts == 1 and trainer.step == TRAIN_STEPS
          and len(resumed.losses) == len(want) and err <= TRAIN_RESUME_ATOL
          and np.isfinite(resumed.losses).all())
    res["a"] = dict(
        losses_plain=plain.losses, losses_resumed=resumed.losses,
        restarts=resumed.restarts, steps_run=resumed.steps_run,
        max_loss_err=err, state_bytes=state_bytes, disk_free=free,
        plain=plain_io, resumed=resumed_io,
        step_ms=float(np.median(plain_io["step_s"][1:]) * 1e3))
    log(f"train (a): {TRAIN_STEPS} steps of batch {TRAIN_BATCH}x"
        f"{TRAIN_SEQ}: loss {plain.losses[0]:.4f} -> "
        f"{plain.losses[-1]:.4f}; a failure before step {TRAIN_FAIL_AT}, "
        f"{resumed.restarts} restart from step {back}, "
        f"{resumed.steps_run} steps run, losses of the same steps within "
        f"{err:.3e} (atol {TRAIN_RESUME_ATOL:g})")
    log(f"train (a) timings: step {res['a']['step_ms']:.1f} ms (median); "
        f"plain run {plain_io['wall_s']:.1f} s, resumed run "
        f"{resumed_io['wall_s']:.1f} s with saves "
        + ", ".join(f"{t:.1f}" for t in resumed_io["saves"])
        + " s and restore "
        + ", ".join(f"{t:.1f}" for t in resumed_io["restores"])
        + f" s of {state_bytes / 2**30:.2f} GiB (disk free "
        f"{free / 2**30:.0f} GiB)")
    if not ok:
        raise SmokeFailure(f"train (a): restarts {resumed.restarts}, step "
                           f"{trainer.step}, losses {resumed.losses} vs "
                           f"{want}")
    return model, trainer


def train_long_step(torch, model, trainer, corpus, res, smi):
    """(b): one train step at TRAIN_BATCH x TRAIN_LONG_SEQ (four CE
    chunks, remat "full"), after a first one; step ms, tokens/s, peak
    memory, device busy share under torch.profiler, and the bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import BrTPFDataPipeline
    from repro_torch.models.model import Model
    cfg = model.cfg
    pipe = BrTPFDataPipeline(corpus, TRAIN_SELECTION, batch_size=TRAIN_BATCH,
                             seq_len=TRAIN_LONG_SEQ)
    batch = train_tensors(torch, next(iter(pipe)))
    chunks = TRAIN_LONG_SEQ // Model.CE_CHUNK
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, metrics, times = timed_steps(
        torch, trainer.step_fn, trainer.params, trainer.opt_state, batch, 1)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, metrics = trainer.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(device_events(torch, prof))
    busy = sum(ns for _, ns in events) / 1e9
    by_name = Counter()
    for name, ns in events:
        by_name[name] += ns / 1e6
    n = sum(p.numel() for p in params.values())
    tokens = TRAIN_BATCH * TRAIN_LONG_SEQ
    flops_ms = 8 * n * tokens / FP32_FLOPS_PER_S * 1e3
    # the optimizer reads parameter, gradient and both moments and writes
    # parameter and both moments, float32
    opt_ms = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
    res["b"] = dict(
        step_ms=times[0] * 1e3, profiled_ms=wall * 1e3,
        tokens_per_s=tokens / times[0], peak_bytes=peak,
        device_s=busy, busy_share=busy / wall, device_events=len(events),
        top_device=by_name.most_common(6), loss=float(metrics["loss"]),
        bound_ms=max(flops_ms, opt_ms), flops_bound_ms=flops_ms,
        opt_bound_ms=opt_ms, ce_chunks=chunks, remat=cfg.remat)
    log(f"train (b) {cfg.name} | {smi}: step {TRAIN_BATCH}x{TRAIN_LONG_SEQ} "
        f"({chunks} CE chunks, remat {cfg.remat}) {times[0] * 1e3:.1f} ms = "
        f"{tokens / times[0]:.0f} tok/s, loss {float(metrics['loss']):.4f}; "
        f"bound {max(flops_ms, opt_ms):.1f} ms (8 N tokens at FP32 peak "
        f"{flops_ms:.1f} ms, optimizer bytes {opt_ms:.1f} ms); peak "
        f"{peak / 2**30:.2f} GiB; profiled step {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.1f} ms = {busy / wall:.3f} over "
        f"{len(events)} device events; top: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in by_name.most_common(4)))
    if not np.isfinite(float(metrics["loss"])):
        raise SmokeFailure("train (b): non-finite loss")


def train_accum(torch, model, batch, res):
    """(c): grad_accum 4 against 1 from the same parameters and a fresh
    optimizer state, on one batch. The gradients of both (one backward,
    and the sum of 4 microbatches' over 4) say which elements are
    decided."""
    from repro_torch.launch.steps import make_grad_step, make_train_step
    from repro_torch.train.optimizer import AdamW, constant_lr
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=constant_lr(ACCUM_LR), weight_decay=0.0)
    start = {n: p.detach().clone() for n, p in params.items()}
    grad_step = make_grad_step(model)
    whole, _ = grad_step(params, batch)
    summed = None
    for i in range(4):
        micro = {k: v[i * len(v) // 4:(i + 1) * len(v) // 4]
                 for k, v in batch.items()}
        grads, _ = grad_step(params, micro)
        if summed is None:
            summed = grads
        else:
            for n, g in grads.items():
                summed[n].add_(g)
    decided = {n: (summed[n] * 0.25 - g).abs() <= ACCUM_DECIDED * g.abs()
               for n, g in whole.items()}
    del whole, summed, grads

    def step(k):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(start[n])
        _, _, m = make_train_step(model, opt, grad_accum=k)(
            params, opt.init(params), batch)
        return float(m["loss"])

    loss1 = step(1)
    after1 = {n: p.detach().clone() for n, p in params.items()}
    loss4 = step(4)
    outside = undecided = bad = total = 0
    worst = 0.0
    for n, p in params.items():
        diff = (p.detach() - after1[n]).abs()
        out = diff > ACCUM_ATOL + ACCUM_RTOL * after1[n].abs()
        outside += int(out.sum())
        undecided += int((out & ~decided[n]).sum())
        bad += int((out & decided[n]).sum()
                   + (diff > 2 * ACCUM_LR + ACCUM_ATOL).sum())
        total += p.numel()
        worst = max(worst, float(diff.max()))
    del after1, start, decided
    loss_rel = abs(loss4 - loss1) / abs(loss1)
    res["c"] = dict(loss1=loss1, loss4=loss4, loss_rel_err=loss_rel,
                    params=total, outside=outside, undecided=undecided,
                    bad=bad, max_abs_diff=worst)
    log(f"train (c) grad_accum 4 vs 1: loss {loss1:.6f} vs {loss4:.6f} rel "
        f"{loss_rel:.3e} (rtol {ACCUM_LOSS_RTOL:g}); {total:,} parameters, "
        f"{outside} outside rtol {ACCUM_RTOL:g} / atol {ACCUM_ATOL:g}, "
        f"{undecided} of them where the gradients differ by more than "
        f"{ACCUM_DECIDED:g} (within 2 lr); largest difference {worst:.3e}")
    if loss_rel > ACCUM_LOSS_RTOL or bad:
        raise SmokeFailure(f"train (c): grad_accum 4 differs from 1 "
                           f"({loss_rel}, {bad} parameters)")


def train_moe(torch, smi):
    """(e): granite-moe-1b-a400m at full width, each MoE dispatch: a grad
    step (loss, aux and gradients finite), then two train steps."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_grad_step, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    out = {}
    rng = np.random.default_rng(3)
    for dispatch in ("einsum", "gather"):
        cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m"),
                                  moe_dispatch=dispatch)
        toks = rng.integers(1, cfg.vocab_size,
                            size=(TRAIN_BATCH, TRAIN_SEQ + 1))
        batch = train_tensors(torch, {"tokens": toks[:, :-1],
                                      "targets": toks[:, 1:]})
        model = build_model(cfg, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
        params = dict(model.named_parameters())
        grads, m = make_grad_step(model)(params, batch)
        ok = finite(torch, grads.values()) and finite(
            torch, [m["loss"], m["moe_aux"]])
        del grads
        opt = AdamW(learning_rate=warmup_cosine(3e-4, 10, TRAIN_STEPS))
        params, _, metrics, times = timed_steps(
            torch, make_train_step(model, opt), params, opt.init(params),
            batch, 2)
        ok = ok and finite(torch, params.values())
        out[dispatch] = dict(loss=float(m["loss"]),
                             moe_aux=float(m["moe_aux"]),
                             step_ms=[t * 1e3 for t in times])
        log(f"train (e) granite-moe-1b-a400m {dispatch} | {smi}: loss "
            f"{float(m['loss']):.4f}, moe_aux {float(m['moe_aux']):.4f}, "
            f"gradients and updated parameters finite: {ok}; steps "
            f"{TRAIN_BATCH}x{TRAIN_SEQ} "
            + ", ".join(f"{t * 1e3:.1f}" for t in times) + " ms")
        del model, params
        torch.cuda.empty_cache()
        if not ok:
            raise SmokeFailure(f"train (e) {dispatch}: non-finite values")
    return out


def run_train(torch, smi):
    """Phase 10: training at qwen2-1.5b's full width, float32, TF32 off."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import BrTPFDataPipeline, SyntheticCorpus
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    corpus = SyntheticCorpus.generate(num_docs=TRAIN_DOCS,
                                      vocab_size=cfg.vocab_size, seed=0)
    pipe = BrTPFDataPipeline(corpus, TRAIN_SELECTION,
                             batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    res = dict(selected_docs=pipe.stats.selected_docs,
               requests=pipe.stats.num_requests,
               data_received=pipe.stats.data_received)
    log(f"train: {cfg.name} at full width, {cfg.num_layers} layers; brTPF "
        f"selection of {TRAIN_DOCS} documents: {pipe.stats.selected_docs} "
        f"selected in {pipe.stats.num_requests} requests "
        f"({pipe.stats.data_received} triples received)")
    model, trainer = train_resume(torch, cfg, pipe, res)
    train_long_step(torch, model, trainer, corpus, res, smi)
    del trainer
    torch.cuda.empty_cache()
    train_accum(torch, model, train_tensors(torch, next(iter(pipe))), res)
    del model
    torch.cuda.empty_cache()

    short = dataclasses.replace(cfg, num_layers=TRAIN_CPU_LAYERS)
    card = build_model(short, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
    batch = {k: np.asarray(v[:TRAIN_CPU_BATCH], np.int64)
             for k, v in next(iter(pipe)).items()}
    res["d"] = grad_card_vs_cpu(
        torch, card, batch, f"train (d) {cfg.name} cut to "
        f"{TRAIN_CPU_LAYERS} layers, grad step {TRAIN_CPU_BATCH}x"
        f"{TRAIN_SEQ}, card vs CPU")
    del card
    torch.cuda.empty_cache()
    res["e"] = train_moe(torch, smi)
    res["seconds"] = time.perf_counter() - t_start
    log(f"train: phase took {res['seconds']:.1f} s")
    return res


# -- phase 11: the RWKV, encoder-decoder and Mamba-hybrid families ---------------

def family_rwkv(torch, smi):
    """rwkv6-7b at full width: the engine at the serve CLI's defaults,
    prefill + FAMILY_DECODE decode steps against the forward (the chunked
    WKV against the stepwise state), card vs CPU cut to 2 layers."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    cfg = get_arch("rwkv6-7b")
    label = cfg.name
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    nparams = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    res = dict(params=nparams, param_bytes=nbytes)
    log(f"lm {label}: {nparams:,} parameters ({nbytes / 2**30:.2f} GiB "
        f"float32) | {smi}")
    toks, gen, _ = lm_engine(torch, model, label, res)
    seq = np.random.default_rng(1).integers(
        1, cfg.vocab_size, size=(1, FAMILY_PROMPT + FAMILY_DECODE))
    path, res["prefill_1_s"], _ = lm_path(
        torch, model, seq[:, :FAMILY_PROMPT], seq[:, FAMILY_PROMPT:],
        seq.shape[1])
    full = model(torch.as_tensor(seq, device="cuda"))[0][
        :, FAMILY_PROMPT - 1:]
    res["c"] = lm_logits_close(
        torch, f"{label} prefill 1x{FAMILY_PROMPT} + {FAMILY_DECODE} decode "
        f"(stepwise WKV state) vs forward 1x{seq.shape[1]} (chunked WKV)",
        path, full)
    res["c"].update(lm_tokens_agree(torch, label, full, path.argmax(-1)))
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del model, full, path
    torch.cuda.empty_cache()
    b_prefill, b_decode = lm_bounds(cfg, nbytes, LM_BATCH, toks.shape[1],
                                    LM_MAX_SEQ)
    res.update(bound_prefill_ms=b_prefill, bound_decode_ms=b_decode)
    log(f"lm {label} numbers | {smi}: prefill {LM_BATCH}x{toks.shape[1]} "
        f"{res['prefill_s'] * 1e3:.2f} ms (bound {b_prefill:.2f} ms); "
        f"prefill 1x{FAMILY_PROMPT} {res['prefill_1_s'] * 1e3:.2f} ms; "
        f"decode batch {LM_BATCH} {res['decode_step_s'] * 1e3:.2f} ms/step = "
        f"{LM_BATCH / res['decode_step_s']:.0f} tok/s (bound "
        f"{b_decode:.2f} ms/step); engine "
        f"{LM_BATCH * LM_NEW_TOKENS / res['generate_s']:.0f} tok/s; peak "
        f"{res['peak_bytes'] / 2**30:.2f} GiB")

    short = dataclasses.replace(cfg, num_layers=2)
    model = build_model(short, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    lm_card_vs_cpu(torch, model, f"{label} cut to 2 layers",
                   np.random.default_rng(2).integers(
                       1, cfg.vocab_size,
                       size=(1, LM_CPU_PROMPT + LM_CPU_DECODE)), res)
    return res


def family_encdec(torch, smi):
    """seamless-m4t-medium at full width: prefill with enc_input plus
    decode against the forward, one train step, card vs CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    cfg = get_arch("seamless-m4t-medium")
    label = cfg.name
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    nparams = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    res = dict(params=nparams, param_bytes=nbytes)
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(ENC_BATCH, ENC_FRAMES, cfg.d_model)) \
        .astype(np.float32)
    seq = rng.integers(1, cfg.vocab_size,
                       size=(ENC_BATCH, ENC_PROMPT + FAMILY_DECODE))
    with torch.inference_mode():
        path, res["prefill_s"], steps = lm_path(
            torch, model, seq[:, :ENC_PROMPT], seq[:, ENC_PROMPT:],
            seq.shape[1], enc_input=enc)
        full = model(torch.as_tensor(seq, device="cuda"),
                     torch.as_tensor(enc, device="cuda"))[0][
            :, ENC_PROMPT - 1:]
    res["decode_step_s"] = float(np.mean(steps))
    log(f"lm {label}: {nparams:,} parameters ({nbytes / 2**30:.2f} GiB "
        f"float32) | {smi}")
    res["c"] = lm_logits_close(
        torch, f"{label} prefill {ENC_BATCH}x{ENC_PROMPT} with enc_input "
        f"{enc.shape} + {FAMILY_DECODE} decode vs forward", path, full)
    res["c"].update(lm_tokens_agree(torch, label, full, path.argmax(-1)))
    del path, full

    toks = rng.integers(1, cfg.vocab_size, size=(ENC_BATCH, TRAIN_SEQ + 1))
    batch = train_tensors(torch, {"tokens": toks[:, :-1],
                                  "targets": toks[:, 1:]})
    batch["enc_input"] = torch.as_tensor(enc, device="cuda")
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(3e-4, 10, TRAIN_STEPS))
    params, _, metrics, times = timed_steps(
        torch, make_train_step(model, opt), params, opt.init(params), batch,
        1)
    ok = finite(torch, params.values()) and np.isfinite(
        float(metrics["loss"]))
    res["train"] = dict(loss=float(metrics["loss"]), step_ms=times[0] * 1e3)
    log(f"lm {label} train step {ENC_BATCH}x{TRAIN_SEQ} with enc_input: "
        f"loss {float(metrics['loss']):.4f}, {times[0] * 1e3:.1f} ms, "
        f"updated parameters finite: {ok}; decode batch {ENC_BATCH} "
        f"{res['decode_step_s'] * 1e3:.2f} ms/step, prefill "
        f"{res['prefill_s'] * 1e3:.2f} ms (bytes bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms)")
    if not ok:
        raise SmokeFailure(f"{label}: non-finite train step")
    with torch.inference_mode():
        lm_card_vs_cpu(torch, model, label,
                       seq[:, :LM_CPU_PROMPT // 4 + LM_CPU_DECODE], res,
                       enc_input=enc)
    return res


def family_hybrid(torch, smi):
    """jamba-1.5-large-398b at reduced_for_smoke (no depth of its full
    width fits one card): a grad step and the prefill/decode path card
    vs CPU, then a train step."""
    import copy

    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW, warmup_cosine
    cfg = reduced_for_smoke(get_arch("jamba-1.5-large-398b"))
    label = cfg.name
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 17))
    res = dict(grads=grad_card_vs_cpu(
        torch, model, {"tokens": toks[:, :-1], "targets": toks[:, 1:]},
        f"{label} grad step 2x16, card vs CPU"))
    host = copy.deepcopy(model)
    with torch.inference_mode():
        lm_card_vs_cpu(torch, host, label, toks, res)
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(3e-4, 10, TRAIN_STEPS))
    batch = train_tensors(torch, {"tokens": toks[:, :-1],
                                  "targets": toks[:, 1:]})
    params, _, metrics, times = timed_steps(
        torch, make_train_step(model, opt), params, opt.init(params), batch,
        1)
    ok = finite(torch, params.values()) and np.isfinite(
        float(metrics["loss"]))
    res["train"] = dict(loss=float(metrics["loss"]), step_ms=times[0] * 1e3)
    log(f"lm {label} train step 2x16: loss {float(metrics['loss']):.4f}, "
        f"moe_aux {float(metrics['moe_aux']):.4f}, {times[0] * 1e3:.1f} ms, "
        f"updated parameters finite: {ok} | {smi}")
    if not ok:
        raise SmokeFailure(f"{label}: non-finite train step")
    return res


def run_families(torch, smi):
    """Phase 11: rwkv6-7b and seamless-m4t-medium at full width, jamba at
    reduced_for_smoke; float32, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = {"rwkv6-7b": family_rwkv(torch, smi)}
    torch.cuda.empty_cache()
    out["seamless-m4t-medium"] = family_encdec(torch, smi)
    torch.cuda.empty_cache()
    out["jamba-1.5-large-398b"] = family_hybrid(torch, smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"families: phase took {out['seconds']:.1f} s")
    return out


# -- phase 12: the sharding layer and the dry-run launchers --------------------

# (a) The production dry-run's named cells: qwen2-1.5b on both H100
# meshes, granite-moe-1b-a400m and jamba-1.5-large-398b at full width on
# gpu32x8, each over its shapes; then both engine variants. jamba's 72
# layers are sampled (one and two block periods, one and two
# microbatches, extrapolated: its full train_4k trace takes 299 s on
# the chip host), the others traced whole.
DRYRUN_CELLS = (
    [("qwen2-1.5b", s, mp, False) for mp in (False, True)
     for s in ("train_4k", "prefill_32k", "decode_32k")]
    + [("granite-moe-1b-a400m", s, False, False)
       for s in ("train_4k", "prefill_32k", "decode_32k")]
    + [("jamba-1.5-large-398b", s, False, True)
       for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")])
# (b) the engine's rank 0 on the card: term ids of its random triples
# (subjects and objects below 2^20, 64 predicates; keys pack 21 bits
# each), timed over ENGINE_ITERS calls (the median).
ENGINE_TERMS, ENGINE_PREDICATES, ENGINE_ITERS = 1 << 20, 64, 10
# (c) qwen2-1.5b's rank 0 run for real: its peak memory against the
# dry-run's per-device bytes for the same cell. The caching allocator
# rounds every block up (512 B, 2 MiB segments) and cuBLAS takes a
# workspace from it, which the trace's exact storage sizes do not see:
# the peak may be up to 25% above the prediction; 10% below it means
# the trace counts storages the program never holds at once. A miss is
# a finding, reported and failed, never widened.
MEM_RATIO_LIMITS = (0.90, 1.25)
# (shape, multi_pod) of each rank-0 run: train_4k on both meshes (the
# same 4-row microbatch), prefill_32k on both meshes (one 32,768-token
# row per data rank: the two-pod mesh shards the batch of 32 over data
# and replicates it over pod), decode_32k on gpu32x8.
RANK0_CELLS = (("train_4k", False), ("train_4k", True),
               ("prefill_32k", False), ("prefill_32k", True),
               ("decode_32k", False))
# The dry-run's per-device GB on gpu2x32x8 over gpu32x8's, for every
# shape traced on both: a train step runs 4-row microbatches on both,
# and the two-pod mesh holds no gradient accumulators between them
# (grad_accum 1 against 2); an inference step holds the same rows per
# rank or fewer. So it needs no more memory; 10% covers the pod axis's
# own ZeRO shards and collectives. A miss fails the phase.
POD_RATIO_LIMIT = 1.10


def check_grads(label, blocks):
    """Log a train step's largest parameter gradient; fail when one was
    held above the shard its rules give (``launch.dryrun.GradBlocks``)."""
    from repro_torch.launch.dryrun import format_grads
    if blocks is None:
        return
    log(f"{label}: {format_grads(blocks)}")
    if blocks["above_shard"]:
        raise SmokeFailure(f"{label}: {len(blocks['above_shard'])} "
                           f"parameter gradients held above their rules' "
                           f"shard: {blocks['above_shard'][:4]}")


def dryrun_table(torch, smi):
    """Phase 12 (a): trace every named cell as rank 0 on fake CUDA
    tensors (the chip host's CPU does the work), and both engine
    variants; one line per cell, its collectives per mesh dim and the
    ops whose operands DTensor redistributed, and a train step's
    parameter gradients against their shards. Fails when a cell needs
    more memory per device than the card has."""
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.engine_dryrun import lower_variant
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    cells, over = {}, []
    for arch, shape, multi_pod, sample in DRYRUN_CELLS:
        rec = trace_cell(arch, shape, multi_pod, sample=sample)
        r, m = rec["roofline"], rec["memory_analysis"]
        if r["memory_per_device_gb"] > card_gb:
            over.append(f"{arch} {shape} {rec['mesh']} "
                        f"{r['memory_per_device_gb']:.3f} GB")
        log(f"dryrun {arch} {shape} {rec['mesh']}: per-device "
            f"{r['memory_per_device_gb']:.3f} GB against the card's "
            f"{card_gb:.3f} GB (arguments "
            f"{m['argument_size_gb']:.3f}, temporaries "
            f"{m['temp_size_gb']:.3f}), compute {r['compute_s']:.5f} s, "
            f"memory {r['memory_s']:.5f} s, collective "
            f"{r['collective_s']:.5f} s, dominant {r['dominant']}, "
            f"grad_accum {rec['grad_accum']}, traced (layers, "
            f"microbatches) {rec['traced']} in {rec['compile_s']:.1f} s"
            f" | {smi}")
        log(f"dryrun {arch} {shape} {rec['mesh']}: collective bytes per "
            f"mesh dim {r['coll_bytes_by_dim']}, counts {r['coll_counts']}")
        for op, kinds in rec["redistributed_ops"].items():
            log(f"dryrun {arch} {shape} {rec['mesh']}: DTensor "
                f"redistributed the operands of {op}: " + ", ".join(
                    f"{k} {v / 1e9:.3f} GB" for k, v in kinds.items()))
        check_grads(f"dryrun {arch} {shape} {rec['mesh']}",
                    rec["grad_blocks"])
        rec.pop("top_ops")
        cells[f"{arch}/{shape}/{rec['mesh']}"] = rec
    for variant in ("baseline", "windowed"):
        rec = lower_variant(variant)
        r = rec["roofline"]
        if r["memory_per_device_gb"] > card_gb:
            over.append(f"brtpf-engine {variant} {rec['mesh']} "
                        f"{r['memory_per_device_gb']:.3f} GB")
        log(f"dryrun brtpf-engine {variant} {rec['mesh']}: per-device "
            f"{r['memory_per_device_gb']:.3f} GB against the card's "
            f"{card_gb:.3f} GB, compute "
            f"{r['compute_s']:.6f} s, memory {r['memory_s']:.6f} s, "
            f"collective {r['collective_s']:.7f} s "
            f"({r['coll_counts']}, {r['coll_bytes_per_chip']:.0f} bytes), "
            f"dominant {r['dominant']} | {smi}")
        rec.pop("top_ops")
        cells[f"brtpf-engine/{variant}/{rec['mesh']}"] = rec
    if over:
        raise SmokeFailure(f"dryrun: {len(over)} cells need more memory "
                           f"per device than the card's {card_gb:.3f} GB: "
                           + "; ".join(over))
    return cells


def engine_inputs(torch, variant, n, gen):
    """Rank 0's partition (2^30 / 32 random triples, SPO-sorted for the
    windowed variant) and a request whose 64 attached mappings come from
    its rows, so that both variants find matches."""
    from repro_torch.kernels.ops import pattern_vec_from
    from repro_torch.launch.engine_dryrun import MAX_MPR
    dev = "cuda"
    s = torch.randint(0, ENGINE_TERMS, (n,), generator=gen, device=dev)
    p = torch.randint(0, ENGINE_PREDICATES, (n,), generator=gen,
                      device=dev)
    o = torch.randint(0, ENGINE_TERMS, (n,), generator=gen, device=dev)
    keys = (s << 42) | (p << 21) | o
    if variant == "windowed":
        keys, order = torch.sort(keys)
        s, p, o = s[order], p[order], o[order]
    rows = torch.stack([s, p, o], dim=1).to(torch.int32)[None]
    valid = torch.ones((1, n), dtype=torch.bool, device=dev)
    pick = torch.randint(0, n, (MAX_MPR,), generator=gen, device=dev)
    pat_valid = torch.ones((MAX_MPR,), dtype=torch.int32, device=dev)
    if variant == "baseline":
        # (?s, P, ?o) with ?s bound to 64 subjects of rows of predicate P
        pred = int(p[pick[0]])
        subj = s[p == pred][:MAX_MPR]
        pats = torch.full((MAX_MPR, 3), -1, dtype=torch.int32, device=dev)
        pats[:len(subj), 0] = subj.to(torch.int32)
        pats[:, 1] = pred
        pat_valid[len(subj):] = 0
        base = torch.as_tensor(pattern_vec_from((-1, pred, -1))).to(dev)
        return (rows, valid, pats, pat_valid, base)
    # (X, ?p, ?o) with ?p bound to X's predicates: a window of its range
    subj = int(s[pick[0]])
    preds = torch.unique(p[s == subj])[:MAX_MPR]
    pats = torch.full((MAX_MPR, 3), -1, dtype=torch.int32, device=dev)
    pats[:, 0] = subj
    pats[:len(preds), 1] = preds.to(torch.int32)
    pat_valid[len(preds):] = 0
    base = torch.as_tensor(pattern_vec_from((subj, -1, -1))).to(dev)
    return (rows, valid, keys[None], pats, pat_valid, base, subj << 42,
            (subj << 42) | ((1 << 42) - 1), 0)


def engine_rank0(torch, smi, wrappers, cells):
    """Phase 12 (b): the engine's distributed step as rank 0 of gpu32x8,
    for real on the card over the fake group: each variant's local page
    and count must equal the single-card step's on the same rows, and
    both kernels must launch. Returns the per-variant numbers and the
    kernels' launches and geometries on this path."""
    from repro_torch.core.federation import FederatedStore, distributed_step
    from repro_torch.launch.engine_dryrun import (CAPACITY, TOTAL_TRIPLES,
                                                  WINDOW)
    from repro_torch.launch.mesh import PRODUCTION, fake_mesh
    gen = torch.Generator("cuda").manual_seed(0)
    n = TOTAL_TRIPLES // PRODUCTION[False][0][0]
    out, launches = {}, Counter()
    shapes = {name: Counter() for name in wrappers}
    single = FederatedStore(shards=1, device=torch.device("cuda"),
                            triples=None, valid=None, keys=None, shard_n=n)
    with fake_mesh(*PRODUCTION[False], device_type="cuda") as mesh:
        for variant in ("baseline", "windowed"):
            args = engine_inputs(torch, variant, n, gen)
            if variant == "baseline":
                step = distributed_step(mesh, CAPACITY)
                want = single.lowerable(CAPACITY)(*args)
            else:
                step = distributed_step(mesh, CAPACITY, window=WINDOW,
                                        shard_n=n, wild_cols=(1, 2))
                want = single.lowerable_windowed(
                    CAPACITY, WINDOW, wild_cols=(1, 2))(*args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in wrappers.values():
                fn.launches = 0
                fn.shapes.clear()
            local = step.local(*args)
            gathered = step.gather(*local)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            for name, fn in wrappers.items():
                launches[name] += fn.launches
                shapes[name].update(fn.shapes)
            same = all(torch.equal(a.to(b.dtype), b)
                       for a, b in zip(local, want, strict=True))
            count = int(local[1].sum())
            ms = sorted(time_ms(torch, lambda: step(*args), 1)
                        for _ in range(ENGINE_ITERS))[ENGINE_ITERS // 2]
            rec = cells[f"brtpf-engine/{variant}/gpu32x8"]["roofline"]
            bound = (rec["memory_s"] + rec["compute_s"]) * 1e3
            out[variant] = dict(
                rows=n, matches=count, equal=same, ms=ms,
                dryrun_ms=bound, peak_gb=peak / 1e9,
                dryrun_gb=rec["memory_per_device_gb"],
                gathered=[list(g.shape) for g in gathered])
            log(f"engine rank 0 {variant}: {n} rows, {count} matches, "
                f"local page and count equal to the single-card step: "
                f"{same}, {ms:.3f} ms (median of {ENGINE_ITERS}) against "
                f"the dry-run's memory + compute {bound:.3f} ms, peak "
                f"{peak / 1e9:.3f} GB against its {rec['memory_per_device_gb']:.3f}"
                f" GB per device | {smi}")
            if not same or count == 0:
                raise SmokeFailure(f"engine rank 0 {variant}: local page "
                                   f"and count differ from the single-card"
                                   f" step or found nothing ({count})")
            del args, local, gathered, want
            torch.cuda.empty_cache()
    for name in ("bindjoin", "tpf_match"):
        if not launches[name]:
            raise SmokeFailure(f"{name} never launched on the engine's "
                               f"rank-0 path: {dict(launches)}")
    log(f"engine rank 0: CUDA launches {dict(launches)}")
    return out, dict(launches), shapes


def fill_rank0(torch, tree, gen, vocab):
    """Rank 0's shards of a step's arguments, from a seed: token ids
    uniform in the vocabulary, parameters normal(0, 0.02), everything
    else (moments, caches, the step counter) zero."""
    seen = set()
    for t in torch.utils._pytree.tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        local = getattr(t, "_local_tensor", t)
        if id(local) in seen:
            continue
        seen.add(id(local))
        with torch.no_grad():
            if local.dim() == 0:
                local.zero_()
            elif not local.is_floating_point():
                local.random_(0, vocab, generator=gen)
            elif isinstance(t, torch.nn.Parameter):
                local.normal_(0.0, 0.02, generator=gen)
            else:
                local.zero_()


def qwen_rank0(torch, smi, cells):
    """Phase 12 (c): qwen2-1.5b's train_4k and prefill_32k steps as rank
    0 of gpu32x8 and of gpu2x32x8, and its decode_32k step on gpu32x8,
    run for real on the card over the fake group (local bf16 shards from
    a seed; collectives return unreduced, so no value is checked): ms
    and peak memory against the dry-run's prediction, and the dry-run's
    two-pod GB against its one-pod GB for every shape traced on both
    meshes (``POD_RATIO_LIMIT``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import GradBlocks, build_step, cell_config
    from repro_torch.launch.mesh import PRODUCTION, fake_mesh, mesh_name
    from repro_torch.sharding.rules import default_rules, use_rules
    out = {}
    for shape_name, multi_pod in RANK0_CELLS:
        cfg, shape = cell_config("qwen2-1.5b", shape_name, False)
        rules = default_rules(multi_pod=multi_pod)
        name = mesh_name(multi_pod, False)
        rec = cells[f"qwen2-1.5b/{shape_name}/{name}"]
        with fake_mesh(*PRODUCTION[multi_pod], device_type="cuda") as mesh:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            gen = torch.Generator("cuda").manual_seed(0)
            model, step, args, _ = build_step(cfg, shape, mesh, rules,
                                              shape.kind)
            fill_rank0(torch, (args, dict(model.named_parameters())), gen,
                       cfg.vocab_size)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            with use_rules(mesh, rules), implicit_replication(), \
                    GradBlocks(model) as grads:
                start.record()
                result = step(*args)
                end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ms = start.elapsed_time(end)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            del model, step, args, result
        blocks = grads.record()
        want = rec["roofline"]["memory_per_device_gb"]
        ratio = peak / want
        out[f"{shape_name}/{name}"] = dict(
            ms=ms, wall_s=wall, peak_gb=peak, dryrun_gb=want, ratio=ratio,
            limits=MEM_RATIO_LIMITS, grad_blocks=blocks)
        log(f"qwen2-1.5b rank 0 {shape_name} {name} on the card: "
            f"{ms:.1f} ms (host {wall:.2f} s), peak {peak:.3f} GB against "
            f"the dry-run's {want:.3f} GB per device (ratio {ratio:.3f}, "
            f"limits {MEM_RATIO_LIMITS[0]}-{MEM_RATIO_LIMITS[1]}); the "
            f"dry-run's memory + compute "
            f"{(rec['roofline']['memory_s'] + rec['roofline']['compute_s']) * 1e3:.1f}"
            f" ms | {smi}")
        torch.cuda.empty_cache()
        check_grads(f"qwen2-1.5b rank 0 {shape_name} {name} on the card",
                    blocks)
        if not MEM_RATIO_LIMITS[0] <= ratio <= MEM_RATIO_LIMITS[1]:
            raise SmokeFailure(f"qwen2-1.5b rank 0 {shape_name} {name}: "
                               f"peak {peak:.3f} GB is {ratio:.3f} x the "
                               f"dry-run's {want:.3f} GB")
    out["pod_ratio"], misses = {}, []
    for arch, shape_name, multi_pod, _ in DRYRUN_CELLS:
        if not multi_pod:        # each two-pod cell is traced on one pod too
            continue
        one, two = (cells[f"{arch}/{shape_name}/{m}"]["roofline"]
                    ["memory_per_device_gb"]
                    for m in ("gpu32x8", "gpu2x32x8"))
        out["pod_ratio"][f"{arch}/{shape_name}"] = dict(
            gpu32x8_gb=one, gpu2x32x8_gb=two, ratio=two / one,
            limit=POD_RATIO_LIMIT)
        log(f"{arch} {shape_name} dry-run per device: gpu2x32x8 {two:.3f} "
            f"GB against gpu32x8 {one:.3f} GB (ratio {two / one:.3f}, "
            f"limit {POD_RATIO_LIMIT}) | {smi}")
        if two / one > POD_RATIO_LIMIT:
            misses.append(f"{arch} {shape_name}: gpu2x32x8 {two:.3f} GB is "
                          f"{two / one:.3f} x gpu32x8's {one:.3f} GB")
    if misses:
        raise SmokeFailure("dry-run per device: " + "; ".join(misses))
    return out


def engine_path_geometries(torch, bj, tm, ops, shapes):
    """Each kernel against its plain version at the geometry the engine's
    rank-0 path launched it at, in phase 6's form."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, tally in shapes.items():
        total = sum(tally.values())
        if not total:
            continue
        geoms, excess = [], 0.0
        for shape, n in tally.most_common():
            r = measure(torch, bj, tm, ops, gen, name, shape)
            geoms.append(dict(r, launches=n))
            excess += n * (r["ms"] - r["bound_ms"])
        out[name] = dict(launches=total, covered=1.0, excess_ms=excess,
                         geometries=geoms)
        log(f"path engine rank 0: {name} {total} launches at "
            f"{[list(g['shape']) for g in geoms]}, launches x (ms - bound) "
            f"{excess:.1f} ms")
    return out


def run_dryrun(torch, smi, bj, tm, ops, wrappers):
    """Phase 12: (a) the production dry-run table, (b) the engine's rank
    0 for real, (c) qwen2-1.5b's rank 0 for real."""
    t0 = time.perf_counter()
    cells = dryrun_table(torch, smi)
    t_table = time.perf_counter() - t0
    log(f"dryrun: {len(cells)} cells traced in {t_table:.1f} s")
    engine, launches, shapes = engine_rank0(torch, smi, wrappers, cells)
    geometries = engine_path_geometries(torch, bj, tm, ops, shapes)
    rank0 = qwen_rank0(torch, smi, cells)
    res = dict(cells=cells, table_s=t_table, engine=engine,
               launches=launches, qwen_rank0=rank0,
               seconds=time.perf_counter() - t0)
    log(f"dryrun: phase took {res['seconds']:.1f} s")
    return res, geometries


# Which kernels each counted path must launch (the grouped paths run
# tpf_match's test in the grouped kernel's prologue: no tpf_match launch).
PATH_KERNELS = {
    "kernel backend": ("bindjoin_grouped", "bindjoin_fused"),
    "sharded backend": ("bindjoin_grouped", "bindjoin_fused"),
    "execute_full": ("tpf_match", "bindjoin"),
    "edge": ("bindjoin_grouped",),
    "sim": ("bindjoin_grouped", "bindjoin_fused"),
    "sim sharded": ("bindjoin_grouped", "bindjoin_fused"),
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

    ends = {"build": time.perf_counter() - t_start}
    wrappers = kernel_wrappers(bj, tm)
    analysis = check_analysis(build, wrappers, smi)
    ends["analysis"] = time.perf_counter() - t_start

    # The store is generated first: phase 3 times the ungrouped kernel
    # at the sharded store's full-stream shape.
    data, generate_s = generate_data(watdiv)
    ends["data"] = time.perf_counter() - t_start
    kernels, single_window = check_kernels(
        torch, bj, tm, ops, SHARDS * -(-len(data.store) // SHARDS))
    ends["kernels"] = time.perf_counter() - t_start

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
    details["analysis"] = analysis
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
        "sim": simulated["kernel"]["launches"],
        "sim sharded": simulated["sharded"]["launches"]}
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
    details["launches_per_path"] = per_path
    log(f"kernels launched on the main paths: {per_path}")

    # Not part of the counted main paths: each kernel at the geometries
    # the paths gave it.
    at_paths, largest_chunk = check_path_geometries(torch, bj, tm, ops,
                                                    shapes_per_path)
    ends["path_kernels"] = time.perf_counter() - t_start
    details["lm"] = run_lm(torch, smi)
    ends["lm"] = time.perf_counter() - t_start
    details["train"] = run_train(torch, smi)
    ends["train"] = time.perf_counter() - t_start
    details["families"] = run_families(torch, smi)
    ends["families"] = time.perf_counter() - t_start
    details["dryrun"], engine_geoms = run_dryrun(torch, smi, bj, tm, ops,
                                                 wrappers)
    ends["dryrun"] = time.perf_counter() - t_start
    per_path["engine rank 0"] = {k: details["dryrun"]["launches"].get(k, 0)
                                 for k in wrappers}
    for name, entry in engine_geoms.items():
        at_paths[name]["engine rank 0"] = entry
    launches = {k: sum(c[k] for c in per_path.values()) for k in wrappers}
    log(f"kernels launched on the main paths, the engine's rank 0 "
        f"included: {launches}")
    log("phases end at (s): " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in ends.items()))
    excess = {k: sum(p["excess_ms"] for p in at_paths[k].values())
              for k in wrappers}
    log("launches x (ms - bound) over the main paths (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    sorted(excess.items(), key=lambda kv: -kv[1])))

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
            name=name, route="cuda", source=SOURCES[name],
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
