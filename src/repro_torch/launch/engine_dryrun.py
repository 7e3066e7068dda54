"""Dry-run + roofline for the brTPF engine itself (the PyTorch
counterpart of ``repro.launch.engine_dryrun``).

Traces rank 0 of the distributed bind-join request step
(``core.federation.distributed_step``) on the production mesh with a
2^30-triple store sharded over the ``data`` axis, on fake tensors (no
data, no allocation):

* ``baseline``  -- the paper-faithful path: every shard streams its whole
  partition through the bind-join kernel; full (capacity, 3) pages are
  all-gathered back.
* ``windowed``  -- beyond-paper: shard-local sorted-range window scan +
  unbound-column projection of the response.

The two CUDA kernels on the path (``bindjoin``, ``tpf_match``) enter
the trace as registered ops (``kernels.ops``) and are charged their
INT32 operations and bytes by the roofline counter.
Writes ``artifacts/dryrun/engine__{variant}.json`` with the same
roofline record as the model cells. Run as ``python -m
repro_torch.launch.engine_dryrun [--variant V] [--device cpu] [--out
DIR]``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..core.federation import distributed_step
from ..kernels.ops import resolve_device
from . import roofline as RL
from .dryrun import ARTIFACT_DIR, run_step
from .mesh import PRODUCTION, fake_mesh, mesh_name

TOTAL_TRIPLES = 1 << 30          # ~1.07B global
MAX_MPR = 64
CAPACITY = 4096
WINDOW = 1 << 17                 # 131,072-row shard window


def inputs(variant: str, shard_n: int, device) -> tuple:
    """Rank 0's step arguments: its [1, shard_n] partition (rows, valid
    flags and, windowed, sorted keys), MAX_MPR attached patterns, the
    base pattern vector and, windowed, the key range and page."""
    rows = torch.empty((1, shard_n, 3), dtype=torch.int32, device=device)
    valid = torch.empty((1, shard_n), dtype=torch.bool, device=device)
    pats = torch.empty((MAX_MPR, 3), dtype=torch.int32, device=device)
    pat_valid = torch.empty((MAX_MPR,), dtype=torch.int32, device=device)
    base_vec = torch.empty((8,), dtype=torch.int32, device=device)
    if variant == "baseline":
        return rows, valid, pats, pat_valid, base_vec
    keys = torch.empty((1, shard_n), dtype=torch.int64, device=device)
    return rows, valid, keys, pats, pat_valid, base_vec, 0, 1 << 40, 0


def step_for(variant: str, mesh, shard_n: int):
    if variant == "baseline":
        return distributed_step(mesh, CAPACITY)
    return distributed_step(mesh, CAPACITY, window=WINDOW, shard_n=shard_n,
                            wild_cols=(1, 2))


def lower_variant(variant: str, out_dir: Optional[str] = None, mesh=None,
                  device: Optional[str] = None) -> Dict:
    """Trace one variant as rank 0; returns (and, with ``out_dir``,
    writes) its record. ``mesh``: a mesh with a ``data`` axis (default:
    the production ``gpu32x8`` over a fake group, made and destroyed
    here)."""
    dev = resolve_device(device)
    ctx = (contextlib.nullcontext(mesh) if mesh is not None
           else fake_mesh(*PRODUCTION[False], device_type=dev.type))
    with ctx as m:
        name = (mesh_name(False) if mesh is None else "x".join(
            str(n) for n in m.shape))
        shard_n = TOTAL_TRIPLES // m.size(m.mesh_dim_names.index("data"))
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = inputs(variant, shard_n, m.device_type)
            counter = RL.CostCounter(RL.group_names(m))
            _, arg_b, out_b, temp_b = run_step(
                step_for(variant, m, shard_n), args, m, {}, counter)
        t_trace = time.time() - t0
        chips = m.size()
    rl = RL.analyze("brtpf-engine", variant, name, chips, counter,
                    model_flops=0.0,
                    memory_gb=(arg_b + out_b + temp_b) / 1e9)
    rec = {
        "arch": "brtpf-engine", "shape": variant, "mesh": name,
        "chips": chips, "device": dev.type,
        "compile_s": round(t_trace, 2),
        "total_triples": TOTAL_TRIPLES, "max_mpr": MAX_MPR,
        "capacity": CAPACITY, "window": WINDOW, "shard_n": shard_n,
        "memory_analysis": {
            "argument_size_gb": arg_b / 1e9,
            "temp_size_gb": (out_b + temp_b) / 1e9,
        },
        "roofline": rl.to_dict(),
        "top_ops": counter.explain(),
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"engine__{variant}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"[engine:{variant}] trace={t_trace:.1f}s "
          f"compute={r['compute_s']:.5f}s memory={r['memory_s']:.5f}s "
          f"coll={r['collective_s']:.6f}s dominant={r['dominant']} "
          f"all-gathers={r['coll_counts'].get('all-gather', 0)} "
          f"coll_bytes={r['coll_bytes_per_chip']:.0f}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--variant", default="",
                    choices=["", "baseline", "windowed"])
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: "
                         "cuda; 'cpu' to trace without a card)")
    args = ap.parse_args(argv)
    variants = [args.variant] if args.variant else ["baseline",
                                                    "windowed"]
    for v in variants:
        lower_variant(v, args.out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
