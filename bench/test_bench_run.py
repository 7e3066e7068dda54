"""Whole runs of the benchmark's cells on the CPU at a small size (the
port's kernels in their plain versions), with the look for a card
skipped: each cell is correct as served and reports its metrics. The
marked test runs a cell on the card."""
from __future__ import annotations

import time

import numpy as np
import pytest

from bench import harness
from bench.testkit import CELLS, SEED, SPEC, one_thread, run  # noqa: F401


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_as_served(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(SPEC, cell, False)}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_traced_run_reads_the_host_side_metrics():
    res = run(CELLS[0], trace=True)
    assert res["correct"]
    host = {"requests_per_query", "edge_ms_per_request", "mean_batch",
            "window_wait_ms", "handle_batch_ms", "launches_per_request"}
    assert host <= set(res["metrics"])
    assert "bindjoin_roofline" not in res["metrics"]   # no card, no trace


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs on the card by "
                    "bench/run.py")
    return torch


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    res = harness.run_cell(CELLS[0], SEED, 3.0, False,
                           t_start=time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite([m["value"] for m in res["metrics"].values()]).all()
