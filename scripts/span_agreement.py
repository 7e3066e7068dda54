"""Set the port's own spans of a traced benchmark run beside the
benchmark's outside spans, over the same profiled sub-window.

Runs one cell as ``python3 bench/run.py --trace 1`` does (the same
harness, seed and window) from the checkout ``--root`` (by default this
one), and prints one JSON line: the run's result (``correct`` and its
metrics) and, for the profiled sub-window ``[profile_t0, profile_t1]``,
the requests answered in it; the benchmark's outside spans in it (mean
``handle_batch`` per flush, mean wait of a batched request, edge per
request); and, where the port records spans
(``repro_torch.core.trace``), its spans per name, the ring's drops and
length, the flushes by cause and the mean flush split into its phases.
The metrics of the whole run cover the sub-window too (``--trace 1``
profiles the window's last 4 s). With ``--cpu-activity`` the profile
records CPU activity as well, and the line adds how far each span's
``record_function`` range in the profile lies from its stamps, moved
onto the profiler's clock by the benchmark's one offset
(``bench/devprof.py``). Needs the CUDA device a cell asks for.

    python3 scripts/span_agreement.py --workload kernel-c64-anchored \\
        --seed 4800000001 [--seconds 50] [--root DIR] [--cpu-activity]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

PHASES = ("prep", "copy_in", "collect", "order", "serve")


def mean(xs):
    return sum(xs) / len(xs) if xs else None


def own_spans(p0, p1):
    try:
        from repro_torch.core.metrics import TRACE
    except ImportError:
        return None
    spans = TRACE.spans(p0, p1)
    flushes = {s.id: s for s in spans if s.name == "flush"}
    split = collections.Counter()
    for s in spans:
        if s.parent in flushes:
            split[s.name] += s.t1 - s.t0
    n = max(len(flushes), 1)
    total = sum(s.t1 - s.t0 for s in flushes.values())
    return dict(
        counts=dict(collections.Counter(s.name for s in spans)),
        dropped=TRACE.dropped(),
        held=len(TRACE.spans(float("-inf"), float("inf"))),
        causes=dict(collections.Counter(s.cause for s in flushes.values())),
        flush_ms=total / 1e6 / n,
        split_ms={k: split[k] / 1e6 / n for k in PHASES},
        unattributed_pct=(100.0 * (total - sum(split.values())) / total
                          if total else None))


def skew(prof) -> dict:
    """Offsets, in microseconds, of each span's range in the profile
    (found by name, nearest start) from its stamps."""
    from repro_torch.core.metrics import TRACE
    starts = collections.defaultdict(list)
    for ev in prof.prof.profiler.kineto_results.events():
        starts[ev.name()].append((ev.start_ns(),
                                  ev.start_ns() + ev.duration_ns()))
    for v in starts.values():
        v.sort()
    d0, d1, missing = [], [], 0
    for s in TRACE.spans(prof.t0, prof.t1):
        got = starts.get(s.name)
        if not got:
            missing += 1
            continue
        a, b = prof.ns(s.t0 / 1e9), prof.ns(s.t1 / 1e9)
        i = bisect.bisect_left(got, (a,))
        near = min(got[max(i - 1, 0):i + 1], key=lambda r: abs(r[0] - a))
        d0.append((near[0] - a) / 1e3)
        d1.append((near[1] - b) / 1e3)

    def q(xs):
        xs = sorted(abs(x) for x in xs)
        if not xs:
            return None
        return dict(median=xs[len(xs) // 2],
                    p99=xs[min(len(xs) - 1, int(0.99 * len(xs)))],
                    max=xs[-1], over_50us=sum(x > 50 for x in xs))

    return dict(spans=len(d0), missing=missing, start_us=q(d0),
                end_us=q(d1))


def observe(run) -> dict:
    """The sub-window's numbers from the run's record, read while the
    benchmark's instruments and the port's ring still hold them."""
    p0, p1 = run.profile_t0, run.profile_t1
    inst = run.instruments

    def sub(name):
        return [(a, b) for a, b in inst.spans[name] if p0 <= b <= p1]

    edge, front = sub("edge"), sub("front")
    handle = sub("handle_batch")
    return dict(
        profile_s=p1 - p0, window_s=run.t1 - run.t0,
        requests_in_profile=run.requests_between(p0, p1),
        outside=dict(
            handle_batch_ms=mean([1e3 * (b - a) for a, b in handle]),
            flushes=len(handle),
            wait_ms=mean([1e3 * w for ts, w in inst.waits
                          if p0 <= ts <= p1]),
            edge_ms=(1e3 * (sum(b - a for a, b in edge)
                            - sum(b - a for a, b in front)) / len(edge)
                     if edge else None)),
        own=own_spans(p0, p1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--cpu-activity", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / sub)
    sys.path[:0] = [str(root), str(root / "src")]
    from bench import devprof, harness

    seen: dict = {}
    profiles = []
    if args.cpu_activity:
        def start(self):
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.offset_ns = time.time_ns() - time.perf_counter() * 1e9
            self.t0 = time.perf_counter()
            profiles.append(self)
        devprof.DeviceProfile.start = start
    readers = harness.readers

    def wrapped(names):
        def reader(mod):
            def read(run):
                if not seen and run.profile_t1 > run.profile_t0:
                    seen.update(observe(run))
                    if profiles:
                        seen["skew"] = skew(profiles[0])
                return mod.read(run)
            return SimpleNamespace(read=read)
        return {n: reader(m) for n, m in readers(names).items()}

    harness.readers = wrapped
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              t_start=T_START)
    import torch
    print(json.dumps(dict(
        workload=args.workload, seed=args.seed, root=str(root),
        torch=torch.__version__, correct=result["correct"],
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        **seen)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
