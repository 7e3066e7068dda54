"""How a cell's rates and tail move with its client count: one run of the
cell per count, in one process, with the mix's clients replaced.

    python3 bench/sweep.py --workload <name> --seed 1 --seconds 20 \
        --clients 4,16,64

prints one JSON line per count. The cells are closed loops, so their load
is their client count; this finds where adding clients stops adding
throughput.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--clients", required=True)
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    from bench.harness import BENCH, find_cell, load_json, run_cell
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, _ = find_cell(spec, args.workload)
    for n in (int(c) for c in args.clients.split(",")):
        mix = load_json(BENCH / "mixes" / f"{cell['traffic']}.json")
        mix["clients"] = n
        res = run_cell(args.workload, args.seed, args.seconds, False,
                       t_start=time.perf_counter(), mix=mix)
        print(json.dumps(dict(workload=args.workload, clients=n,
                              correct=res["correct"],
                              metrics={k: v["value"] for k, v
                                       in res["metrics"].items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
