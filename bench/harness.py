"""One run of one benchmark cell, found by name in ``BENCHMARK.json``.

A cell names a configuration (``bench/configs/<name>.json``: the data
scale and the server's settings) and a traffic mix
(``bench/mixes/<name>.json``: clients, request budget, query templates
and how their constants are drawn, warm-up, and the sample the check
takes). Every metric, end to end or per layer, is read by
``bench/metrics/<name>.py`` from the run's record (``RunData``), and each
kernel whose roofline is read has a file in ``bench/roofline/``. Nothing
here names a cell, a configuration, a mix or a metric.

A run, as timed:

1. set-up: load the CUDA kernels, make the data from the seed, hand it
   to the port (``watdiv.from_arrays``), build its HTTP edge
   (``app_from_config``: brtpf/v1 codec, ``AsyncBrTPFServer``,
   ``BrTPFServer``, the configured selector), and warm it up with the
   mix's own traffic on other draws of the seed;
2. the window: the mix's clients, each a closed-loop
   ``AsyncBrTPFClient`` over an ``AsgiTransport`` into the edge, run
   their own query streams for ``seconds``; a query that has started
   runs to its end, for at most a minute past the close;
3. the check, once the window has closed, the device's peak has been
   read and the program's state is freed: a sample of the fragments the
   clients received and of the solutions of the queries that ended
   complete, against the NumPy reference (``check``, ``reference``).
"""
from __future__ import annotations

import asyncio
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import check, reference, datagen
from .devprof import DeviceProfile, summary_line

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# Top-level module names the measured process must not hold: JAX and the
# JAX package (whose name the port's begins with, so names are compared
# whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GRACE_S = 60.0
# The traced run profiles the last PROFILE_S seconds of its window, or
# the mix's ``profile_seconds`` (at most half of the window): a bounded
# trace, held in memory but for one temporary file that is read for its
# copy bytes and deleted.
PROFILE_S = 4.0


class RunFailed(RuntimeError):
    """The run cannot report a result (no card for the cell, no
    configuration or mix by that name)."""


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(spec: dict, workload: str):
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunFailed(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, config


def metrics_of(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those whose ``workloads`` list it, or that have none."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def readers(names) -> Dict[str, object]:
    return {n: importlib.import_module(f"bench.metrics.{n}") for n in names}


def rooflines() -> Dict[str, object]:
    """Each kernel file of ``bench/roofline/`` by name (``common`` holds
    what they share)."""
    return {p.stem: importlib.import_module(f"bench.roofline.{p.stem}")
            for p in sorted((BENCH / "roofline").glob("*.py"))
            if p.stem not in ("__init__", "common")}


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (the modules this
    process holds), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names
                   if name.split(".")[0] in FORBIDDEN})


class Recorder:
    """The clients' transport: the ASGI transport, with every request
    and the answer it received kept while ``on``, the requests answered
    with an error, and the requests in flight. (A client cancels its own
    requests in flight when a query reaches its budget.)"""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.on = False
        self.log: list = []
        self.errors: List[str] = []
        self.inflight = 0

    @property
    def max_mpr(self) -> int:
        return self.inner.max_mpr

    async def handle(self, req):
        t0 = time.perf_counter()
        self.inflight += 1
        try:
            frag = await self.inner.handle(req)
        except Exception as exc:
            if self.on:
                self.errors.append(repr(exc))
            raise
        finally:
            self.inflight -= 1
        if self.on:
            self.log.append((t0, time.perf_counter(), req, frag))
        return frag


class RunData:
    """What the per-layer readers read (``bench/metrics/*.py``)."""

    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)

    def window_spans(self, name: str):
        return [(a, b) for a, b in self.instruments.spans[name]
                if self.t0 <= b <= self.t1] if self.instruments else []

    def requests_between(self, lo: float, hi: float) -> int:
        return sum(1 for _, t, _, _ in self.log if lo <= t <= hi)


def own_spans_line(t0: float, t1: float) -> str:
    """How many of the port's own spans (``repro_torch.core.trace``) and
    flushes ended in ``[t0, t1]``, and how many its ring dropped."""
    try:
        from repro_torch.core.metrics import TRACE
    except ImportError:
        return "no own spans"
    spans = TRACE.spans(t0, t1)
    flushes = sum(s.name == "flush" for s in spans)
    return (f"own spans: {len(spans)} ended in the profile, {flushes} "
            f"flushes, {TRACE.dropped()} dropped")


def device_facts(torch, device: str) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda",
             spec: Optional[dict] = None, config: Optional[dict] = None,
             mix: Optional[dict] = None, grace_s: float = GRACE_S,
             keep: bool = False) -> dict:
    """Run one cell and return its result line (a dict). ``device``
    "cpu", with ``config`` and ``mix`` in place of the files, runs the
    kernels' plain versions at a size the CPU tests can hold; ``keep``
    adds the check's inputs under ``"_state"`` (for the control)."""
    t_cell = time.perf_counter()
    import torch

    spec = spec or load_json(ROOT / "BENCHMARK.json")
    cell, cfg_entry = find_cell(spec, workload)
    config = config or load_json(ROOT / cfg_entry["file"])
    mix = mix or load_json(BENCH / "mixes" / f"{cell['traffic']}.json")
    wanted = metrics_of(spec, workload, trace)

    if device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            raise RunFailed(f"{workload} needs {cell['chips']} CUDA "
                            "device(s)")
    t_device = time.perf_counter() - t_cell
    from repro_torch.core import (AsyncBrTPFClient, ServerConfig,
                                  bgp_from_arrays)
    from repro_torch.data import watdiv
    from repro_torch.serving.http import app_from_config
    from repro_torch.serving.transport import AsgiTransport

    steps = {"start_s": t_cell - t_start, "device_s": t_device,
             "import_s": time.perf_counter() - t_cell - t_device}
    t = time.perf_counter()
    if device == "cuda":
        from repro_torch.kernels import build
        built = build.build_all()
        log(f"kernels: {len(built)} sources compiled")
    steps["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    triples, lay = datagen.generate(config["dataset"]["scale"], seed)
    steps["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    terms = lay.terms()
    steps["terms_s"] = time.perf_counter() - t
    t = time.perf_counter()
    _, store = watdiv.from_arrays(triples, terms)
    del terms
    steps["store_s"] = time.perf_counter() - t
    t = time.perf_counter()
    server_cfg = ServerConfig(**config["server"], device=device)
    app = app_from_config(store, server_cfg, **config["front"])
    steps["edge_s"] = time.perf_counter() - t
    front = app.backend
    server = front.server
    transport = AsgiTransport(app)
    recorder = Recorder(transport)
    n_clients = int(mix["clients"])
    clients = [AsyncBrTPFClient(recorder,
                                request_budget=int(mix["request_budget"]))
               for _ in range(n_clients)]
    log(f"data: {len(store)} triples, {lay.num_terms} terms; "
        f"{config['server']}")

    state = dict(queries=[], query_errors=[], instruments=None, unanswered=0,
                 profile=None, snap0=None, snap1=None, t0=0.0, t1=0.0)
    kernels = rooflines()
    prof = DeviceProfile(torch) if trace and device == "cuda" else None
    if prof is not None:
        t = time.perf_counter()
        prof.prime()
        steps["profiler_s"] = time.perf_counter() - t

    def snapshot():
        return dict(batch=dict(requests=front.stats.requests,
                               flushes=front.stats.flushes),
                    cuda=dict(vars(server.cuda_work())),
                    requests=server.counters.num_requests)

    async def warm(c: int) -> None:
        stream = datagen.client_stream(mix, lay, seed, 0, c)
        for _ in range(int(mix["warmup_queries_per_client"])):
            _name, pats = next(stream)
            await clients[c].execute(bgp_from_arrays(pats.tolist()))

    async def client_loop(c: int, t_end: float) -> None:
        stream = datagen.client_stream(mix, lay, seed, 1, c)
        while time.perf_counter() < t_end:
            name, pats = next(stream)
            q0 = time.perf_counter()
            try:
                res = await clients[c].execute(
                    bgp_from_arrays(pats.tolist()))
            except Exception as exc:  # counted, and the client goes on
                state["query_errors"].append(repr(exc))
                continue
            state["queries"].append(dict(
                t0=q0, t1=time.perf_counter(), name=name, patterns=pats,
                requests=res.num_requests, timed_out=res.timed_out,
                solutions=res.solutions))

    def close() -> None:
        state["snap1"] = snapshot()
        state["gc1"] = [g["collections"] for g in gc.get_stats()]
        if prof is not None and prof.prof is not None:
            prof.stop()

    async def drive() -> None:
        t = time.perf_counter()
        await asyncio.gather(*[warm(c) for c in range(n_clients)])
        if device == "cuda":
            torch.cuda.synchronize()
        steps["warmup_s"] = time.perf_counter() - t
        if trace:
            from .spans import Instruments
            state["instruments"] = Instruments(transport, front, server,
                                               kernels)
        loop = asyncio.get_running_loop()
        state["gc0"] = [g["collections"] for g in gc.get_stats()]
        recorder.on = True
        state["snap0"] = snapshot()
        t0 = state["t0"] = time.perf_counter()
        t_end = state["t1"] = t0 + seconds
        loop.call_later(seconds, close)
        if prof is not None:
            profile_s = float(mix.get("profile_seconds", PROFILE_S))
            loop.call_later(max(seconds - profile_s, seconds / 2),
                            prof.start)
        tasks = [asyncio.ensure_future(client_loop(c, t_end))
                 for c in range(n_clients)]
        _, pending = await asyncio.wait(tasks, timeout=seconds + grace_s)
        state["unanswered"] = recorder.inflight if pending else 0
        for task in pending:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        recorder.on = False
        if state["snap1"] is None:
            close()
        await app.aclose()

    try:
        asyncio.run(drive())
    finally:
        if state["instruments"] is not None:
            state["instruments"].restore()
    dev = device_facts(torch, device)
    setup_s = state["t0"] - t_start
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f"; setup_s {setup_s:.3f} (from process start)")

    t0, t1 = state["t0"], state["t1"]
    ended = [q for q in state["queries"] if t0 <= q["t1"] <= t1]
    done = [rec for rec in recorder.log if t0 <= rec[1] <= t1]
    sent = [rec for rec in recorder.log if t0 <= rec[0] <= t1]
    s0, s1 = state["snap0"], state["snap1"]
    run = RunData(
        t0=t0, t1=t1, seconds=seconds, setup_s=setup_s, queries=ended,
        log=recorder.log,
        batch={k: s1["batch"][k] - s0["batch"][k] for k in s0["batch"]},
        cuda={k: s1["cuda"][k] - s0["cuda"][k] for k in s0["cuda"]},
        server_requests=s1["requests"] - s0["requests"],
        instruments=state["instruments"],
        waits=[w for ts, w in state["instruments"].waits if t0 <= ts <= t1]
        if state["instruments"] else [],
        profile=None, profile_t0=0.0, profile_t1=0.0,
        peaks=load_json(BENCH / "roofline" / "peaks.json"),
        rooflines=kernels)
    bins = np.histogram([rec[1] for rec in done], range=(t0, t1),
                        bins=max(1, int(seconds // 5)))[0]
    log(f"answered per 5 s: {bins.tolist()}")
    log(f"window: {len(ended)} queries ended "
        f"({sum(q['timed_out'] for q in ended)} at the budget), "
        f"{len(done)} requests answered, {len(sent)} sent; "
        f"{len(state['queries']) - len(ended)} queries ended after it; "
        f"batch {run.batch}, cuda {run.cuda}; garbage collections "
        f"{[b - a for a, b in zip(state['gc0'], state['gc1'])]}")

    result: Dict[str, object] = {}
    device_out = dict(dev)
    breakdown = None
    if trace and prof is not None and prof.prof is not None:
        inst = state["instruments"]
        run.profile = prof.read(inst.launches, inst.spans, kernels)
        run.profile_t0, run.profile_t1 = prof.t0, prof.t1
        log(f"profile: {summary_line(run.profile)}; "
            f"{own_spans_line(prof.t0, prof.t1)}")
        device_out.update(busy_s=run.profile["busy_s"],
                          window_s=run.profile["window_s"])
        breakdown = {"device_ops": run.profile["device_ops"],
                     "idle_gaps": run.profile["idle_gaps"]}
    metrics: Dict[str, dict] = {}
    for m in wanted:
        value = readers([m["name"]])[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The check: after the peak is read and the program's state is freed.
    served = [(tuple(int(x) for x in req.pattern.as_tuple()),
               None if req.omega is None else np.asarray(req.omega),
               int(req.page), bool(req.count_only),
               np.asarray(frag.data), int(frag.cnt), bool(frag.has_next))
              for _, _, req, frag in recorder.log]
    complete = [q for q in state["queries"] if not q["timed_out"]]
    n_errors, n_cancelled = len(recorder.errors), state["unanswered"]
    attempted = len(sent) + n_errors + n_cancelled
    failed = n_errors + n_cancelled
    for err in sorted(set(recorder.errors + state["query_errors"]))[:5]:
        log(f"error: {err}")
    page_size = server.page_size
    del app, front, server, transport, recorder, clients, store, run
    state["instruments"] = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        # Read after the window, so that set-up does no work for the log.
        log(f"device: {dev['kind']}; {power_line()}")

    t = time.perf_counter()
    rng = np.random.default_rng(datagen.seed_sequence(seed, 2))
    ref = reference.ReferenceStore(triples)
    answers = check.Answers(ref, page_size)
    frag_idx = check.sample(len(served), int(mix["check"]["fragments"]), rng)
    largest = sorted(range(len(complete)),
                     key=lambda i: -complete[i]["solutions"].shape[0])[:5]
    query_idx = check.sample(len(complete), int(mix["check"]["queries"]),
                             rng, first=largest)
    sampled = [served[i] for i in frag_idx]
    queries = [(complete[i]["patterns"], complete[i]["solutions"])
               for i in query_idx]
    values = dict(
        fragment_mismatches=check.fragment_mismatches(answers, sampled),
        solution_mismatches=check.solution_mismatches(ref, queries),
        request_errors=n_errors, unanswered_requests=n_cancelled,
        query_errors=len(state["query_errors"]))
    correct, checks = check.verdict(values)
    log(f"check: {len(sampled)} of {len(served)} fragments and "
        f"{len(queries)} of {len(complete)} complete queries against the "
        f"reference in {time.perf_counter() - t:.1f}s")
    result.update(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=device_out)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    if keep:
        result["_state"] = dict(ref=ref, sampled=sampled, queries=queries,
                                page_size=page_size)
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return result
