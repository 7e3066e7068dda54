"""What rank 0 holds at the peak of its real qwen2-1.5b train_4k step on
the card, beside what the dry-run's trace counts.

Runs the step as rank 0 of ``gpu32x8`` (``--multi-pod``: ``gpu2x32x8``)
over the fake process group, as ``chip_smoke.py``'s phase 12 (c) does,
with the CUDA caching allocator's history on; replays the history's
allocations and frees to the peak and prints each block of at least
``--min-bytes`` live there: its size, the last ``repro_torch`` line that
allocated before it, and the C++ frames of the ops that allocated it
(autograd nodes and ATen kernels, whose inner allocations no dispatch
mode sees). Ends with the dry-run's per-device GB of the same cell.
Needs a CUDA device.

    python scripts/rank0_peak.py [--multi-pod] [--min-bytes 400000000]
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402
from torch.distributed.tensor.experimental import \
    implicit_replication  # noqa: E402

import chip_smoke  # noqa: E402  (fill_rank0: the seeded shards)
from repro_torch.launch.dryrun import (build_step, cell_config,  # noqa: E402
                                       trace_cell)
from repro_torch.launch.mesh import PRODUCTION, fake_mesh  # noqa: E402
from repro_torch.sharding.rules import default_rules, use_rules  # noqa: E402

KEEP = ("autograd", "at::native", "Backward")


def peak_blocks(snap):
    """(peak bytes, [(event, size, last repro_torch line)]) of the blocks
    live at the peak of the first device's trace."""
    live, cur, best, best_set, last = {}, 0, 0, {}, None
    for i, ev in enumerate(snap["device_traces"][0]):
        if ev["action"] == "alloc":
            own = [f for f in ev.get("frames", [])
                   if "repro_torch" in f["filename"]]
            if own:
                f = own[0]
                last = (f"{f['filename'].split('repro_torch/')[-1]}:"
                        f"{f['line']}:{f['name']}")
            live[ev["addr"]] = (i, ev["size"], last)
            cur += ev["size"]
            if cur > best:
                best, best_set = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[1]
    return best, sorted(best_set.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--min-bytes", type=int, default=400_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 2
    cfg, shape = cell_config("qwen2-1.5b", "train_4k", False)
    rules = default_rules(multi_pod=args.multi_pod)
    with fake_mesh(*PRODUCTION[args.multi_pod], device_type="cuda") as mesh:
        model, step, step_args, _ = build_step(cfg, shape, mesh, rules,
                                               "train")
        chip_smoke.fill_rank0(torch, step_args,
                              torch.Generator("cuda").manual_seed(0),
                              cfg.vocab_size)
        torch.cuda.synchronize()
        torch.cuda.memory._record_memory_history(max_entries=2_000_000)
        with use_rules(mesh, rules), implicit_replication():
            step(*step_args)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        del model, step, step_args
    events = snap["device_traces"][0]
    best, blocks = peak_blocks(snap)
    print(f"peak of the step's own allocations {best / 1e9:.3f} GB")
    for i, size, last in blocks:
        if size < args.min_bytes:
            continue
        print(f"{size} bytes (event {i}), after {last}")
        frames = [f["name"][:100] for f in events[i].get("frames", [])
                  if any(k in f["name"] for k in KEEP)]
        for name in frames[:6]:
            print(f"    {name}")
    rec = trace_cell("qwen2-1.5b", "train_4k", args.multi_pod)
    m = rec["memory_analysis"]
    print(f"dry-run {rec['mesh']}: {rec['roofline']['memory_per_device_gb']:.3f}"
          f" GB per device (arguments {m['argument_size_gb']:.3f}, "
          f"temporaries {m['temp_size_gb']:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
