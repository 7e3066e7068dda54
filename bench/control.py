"""The control of the comparison that decides ``correct``, read on the
card at a cell's own size: on each seed, one run of the cell (the
program serving as in the benchmark, over a short window), then, on the
same sampled requests, the reference's pages and the control's.

The control is the reference put in the program's place with one
guarantee of the configuration broken: each instantiated pattern's
matches come in the store's storage order (subject, predicate, object)
instead of the stream order of the permutation its bound prefix selects
(``control_fragment``). That is the step a change would take by dropping
the selectors' stream-order epilogue, a host cost of the served path.
The comparison has to count the control's pages as wrong.

    python3 bench/control.py --workload <name> --seconds 5 \
        --seeds 11,12,13

prints, per seed, the program's and the control's mismatching pages of
the sample, and the program's other checks.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def control_fragment(store, pattern, omega):
    """``reference.fragment`` with each instantiation's matches in
    storage order."""
    from bench import reference
    if omega is None or len(omega) == 0:
        insts = [tuple(int(x) for x in pattern)]
    else:
        insts = list(dict.fromkeys(reference.instantiate(pattern, row)
                                   for row in np.asarray(omega)))
    streams = []
    for p in insts:
        m = store.match(p)
        streams.append(m[np.lexsort((m[:, 2], m[:, 1], m[:, 0]))])
    return (reference.first_occurrences(streams),
            int(sum(s.shape[0] for s in streams)))


def control_reading(state) -> int:
    """Pages of the run's sample on which the control's answer differs
    from the reference's."""
    from bench import check
    ref = check.Answers(state["ref"], state["page_size"])
    ctl = check.Answers(state["ref"], state["page_size"], control_fragment)
    return sum(not check.same_page(s[:4] + ctl.page(*s[:4]),
                                   ref.page(*s[:4]))
               for s in state["sampled"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    from bench.harness import run_cell
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(args.workload, seed, args.seconds, False,
                       t_start=time.perf_counter(), keep=True)
        state = res.pop("_state")
        print(json.dumps(dict(
            workload=args.workload, seed=seed, correct=res["correct"],
            sampled=len(state["sampled"]), checks=res["checks"],
            control_fragment_mismatches=control_reading(state))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
