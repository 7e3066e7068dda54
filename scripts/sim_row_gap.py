"""The raw-row gap of the simulator's live replay, on the CPU.

Builds the WatDiv-like store at ``--scale`` times the default (60: 925,089
triples), picks chip_smoke.py's 8 queries (the first two of each of the L,
S, F and C families of ``generate_workload(seed=1)``), collects their
traces on the kernel backend (the kernels' plain versions) with a budget
of 60 requests per query, and replays them by 4 clients through a 2 ms
batching window with ``sim.live_replay``. Prints the simulated and the
observed raw candidate rows, the traces' summed rows, and the rows the
model simulates once each trace has a name of its own: the model's memo
keys a fragment's owner by query name, and two queries of one WatDiv
template share theirs.

    PYTHONPATH=src python scripts/sim_row_gap.py [--scale 60]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the phase-8 workload and constants)
from repro_torch import core  # noqa: E402
from repro_torch.core import sim  # noqa: E402
from repro_torch.data import watdiv  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=60)
    args = parser.parse_args(argv)
    base = watdiv.WatDivScale()
    data = watdiv.generate(watdiv.WatDivScale(**{
        f: getattr(base, f) * args.scale
        for f in ("users", "products", "reviews", "retailers", "genres",
                  "cities", "tags")}), seed=0)
    queries = chip_smoke.pick_queries(watdiv, data)
    cfg = core.ServerConfig(selector_backend="kernel", fast_path_rows=0,
                            device="cpu")
    traces = [dataclasses.replace(t, completed=True)
              for t in sim.collect_traces(
                  core.BrTPFServer(data.store, cfg), queries, "brtpf",
                  request_budget=chip_smoke.REQUEST_BUDGET)]
    rows = sum(ev.cand_rows for t in traces for ev in t.events
               if isinstance(ev, sim.HttpRecord))
    params = sim.SimParams()
    lv = sim.live_replay(sim.split_workload(traces, chip_smoke.SIM_CLIENTS),
                         core.BrTPFServer(data.store, cfg), params,
                         batch_window_s=chip_smoke.SIM_WINDOW_S)
    # the model of live_replay, each trace named apart
    named = [dataclasses.replace(t, name=f"{t.name}#{i}")
             for i, t in enumerate(traces)]
    apart = sim.simulate(
        sim.split_workload(named, chip_smoke.SIM_CLIENTS),
        dataclasses.replace(params, batch_window_s=chip_smoke.SIM_WINDOW_S,
                            server_workers=1))
    print(f"{len(data.store)} triples, queries "
          + " ".join(t.name for t in traces))
    print(f"raw candidate rows: simulated {lv.simulated_cand_rows}, "
          f"observed {lv.observed_cand_rows}, the traces' sum {rows}; "
          f"simulated with each trace named apart {apart.cand_rows}")
    print(f"launches: simulated {lv.simulated_launches} (named apart "
          f"{apart.launches}), observed {lv.observed_launches}; skipped: "
          f"simulated {lv.simulated_skipped} (named apart "
          f"{apart.launches_skipped}), observed {lv.observed_skipped}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
