"""What the CPU tests of whole runs share: the cells of
``BENCHMARK.json``, a seed past 32 bits, each cell cut to a size the
CPU holds, and one thread for PyTorch while a test runs."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**32 + 17


def small(cell: str):
    """The cell's configuration at the port generator's default scale,
    and its mix with 4 clients and a smaller check."""
    w, cfg = harness.find_cell(SPEC, cell)
    config = harness.load_json(ROOT / cfg["file"])
    for k in ("users", "products", "reviews", "retailers", "genres",
              "cities", "tags"):
        config["dataset"]["scale"][k] //= 600
    mix = harness.load_json(ROOT / "bench" / "mixes" / f"{w['traffic']}.json")
    mix.update(clients=4, check={"fragments": 400, "queries": 40})
    return config, mix


@pytest.fixture(autouse=True)
def one_thread():
    """Several test processes share the CPU: one thread each keeps a
    run's window from starving."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cell: str, trace: bool = False, seconds: float = 1.0,
        warmup: int = 1, **kw):
    """One whole run of ``cell`` on the CPU (the kernels' plain
    versions), with the look for a card skipped."""
    config, mix = small(cell)
    mix["warmup_queries_per_client"] = warmup
    return harness.run_cell(cell, SEED, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            config=config, mix=mix, **kw)
