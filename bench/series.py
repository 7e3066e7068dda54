"""Run several runs of the benchmark one after another, each in its own
process as the check runs them, and summarise them.

    python3 bench/series.py --out chiprun_out/bench/<tag> --seconds 20 \
        kernel-c64-anchored:101:0 kernel-c64-anchored:102:0 ...

Each argument is ``workload:seed:trace``. Every run's standard output
and error go to ``<out>/<index>.<workload>.<seed>.<trace>.log``; the result
lines go to ``<out>/results.jsonl``. At the end, for each workload and
trace setting with four runs or more, the spread of each metric (the
distance between its quartiles over its median).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results = defaultdict(list)
    for i, run in enumerate(args.runs):
        workload, seed, trace = run.split(":")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
             workload, "--seed", seed, "--seconds", str(args.seconds),
             "--trace", trace], capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t
        (out / f"{i:02d}.{workload}.{seed}.{trace}.log").write_text(
            proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
        try:
            res = json.loads(line)
        except ValueError:
            res = None
        rec = dict(workload=workload, seed=int(seed), trace=int(trace),
                   rc=proc.returncode, wall_s=wall, result=res)
        with open(out / "results.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        if res is None:
            print(f"{run}: rc {proc.returncode}, no result, {wall:.1f}s; "
                  + proc.stderr[-1500:], flush=True)
            continue
        results[(workload, trace)].append(res)
        vals = " ".join(f"{k}={v['value']:.6g}"
                        for k, v in res["metrics"].items())
        dev = res["device"]
        print(f"{run}: rc {proc.returncode} correct {res['correct']} "
              f"{wall:.1f}s {vals} peak {dev['memory_peak_bytes']} "
              + (f"busy {dev.get('busy_s'):.4g}/{dev.get('window_s'):.4g}"
                 if "busy_s" in dev else ""), flush=True)
    for (workload, trace), rs in results.items():
        if len(rs) < 4:
            continue
        for name in rs[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in rs
                    if name in r["metrics"]]
            print(f"spread {workload} trace {trace} {name}: "
                  f"{spread(vals):.4f} over {len(vals)} runs "
                  f"(median {sorted(vals)[len(vals) // 2]:.6g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
