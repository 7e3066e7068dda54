"""How complete torch.profiler's device records are on a loaded host.

Profiles ``chip_smoke.py``'s phase-8 trace collection (the sharded
backend over the slice's WatDiv-like store and queries) once on a quiet
host, then ``--trials`` times beside ``--busy`` processes that spin on
the CPU. Each trial prints the device records the profiler kept, the
bind-join kernels among them against the traces' CUDA launches, the
kernel launches and copies it recorded on the host without a device
record, and how far its clock put a device record before its call
(``chip_smoke.lost_device_records``). With ``--run SCRIPT`` it
runs that script beside the busy processes instead, and exits with its
code. Needs a CUDA device.

    python scripts/profile_under_load.py [--busy 8] [--trials 6]
    python scripts/profile_under_load.py --busy 8 --run chip_smoke.py
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def spin(n):
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(n)]


def trial(torch, core, sim, smoke, data, queries, cfg):
    from torch.profiler import ProfilerActivity, profile
    server = core.BrTPFServer(data.store, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traces = sim.collect_traces(server, queries, "brtpf",
                                    request_budget=smoke.REQUEST_BUDGET)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    events = list(smoke.device_events(torch, prof))
    return dict(
        seconds=secs, device_records=len(events),
        bindjoin=sum("bindjoin" in name for name, _ in events),
        traces=sum(e.cuda_launches for t in traces for e in t.events
                   if isinstance(e, sim.HttpRecord) and e.cand > 0),
        lost=smoke.lost_device_records(torch, prof))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--busy", type=int, default=8)
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--run", help="a script to run beside the busy "
                    "processes instead of the trials")
    args = ap.parse_args(argv)
    if args.run:
        procs = spin(args.busy)
        try:
            return subprocess.run([sys.executable, args.run],
                                  cwd=ROOT).returncode
        finally:
            for p in procs:
                p.kill()
                p.wait()

    import torch

    import chip_smoke as smoke
    from repro_torch import core
    from repro_torch.core import sim
    from repro_torch.data import watdiv
    from repro_torch.kernels import build
    build.build_all()
    data, _ = smoke.generate_data(watdiv)
    queries = smoke.pick_queries(watdiv, data)
    cfg = core.ServerConfig(selector_backend="sharded", fast_path_rows=0,
                            shards=smoke.SHARDS)
    rows = [("quiet", trial(torch, core, sim, smoke, data, queries, cfg))]
    procs = spin(args.busy)
    try:
        rows += [(f"{args.busy} busy", trial(torch, core, sim, smoke, data,
                                             queries, cfg))
                 for _ in range(args.trials)]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (label, r) in enumerate(rows):
        print(f"trial {i} ({label}): {r['device_records']} device records, "
              f"bind-join {r['bindjoin']} against the traces' "
              f"{r['traces']}; {smoke.profile_losses(r['lost'])}; "
              f"{r['seconds']:.1f} s")
    short = [r for _, r in rows if r["bindjoin"] != r["traces"]]
    explained = all(0 < r["traces"] - r["bindjoin"] <= r["lost"]["launches"]
                    for r in short)
    print(f"{sum(r['lost']['launches'] > 0 for _, r in rows)} of "
          f"{len(rows)} profiles lost kernel launches, {len(short)} short "
          f"of the traces' launches, each by no more than it lost: "
          f"{explained} | {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
