"""The control and the faults a cell can have, each through a whole run
on the CPU at a small size with the look for a card skipped: each comes
out not correct."""
from __future__ import annotations

import asyncio
import importlib
import subprocess
import sys

import numpy as np

from bench import control
from bench.testkit import CELLS, ROOT, one_thread, run  # noqa: F401


def test_control_fails_the_comparison_the_program_passes():
    """The reference with its streams in storage order, in the program's
    place, on the run's own sample."""
    res = run(CELLS[0], keep=True)
    state = res.pop("_state")
    assert res["checks"]["fragment_mismatches"]["value"] == 0
    assert control.control_reading(state) > 0


def test_an_answer_altered_in_the_kernel_is_caught(monkeypatch):
    """The grouped kernel (every fused launch too) drops the first row
    it would keep: served pages miss a triple."""
    bindjoin = importlib.import_module("repro_torch.kernels.bindjoin")
    inner = bindjoin.bindjoin_grouped_plain

    def broken(*args, **kw):
        mask, first, cnt, nmatch = inner(*args, **kw)
        hit = mask.nonzero()
        if hit.shape[0]:
            mask[tuple(hit[0])] = 0
        return mask, first, cnt, nmatch

    monkeypatch.setattr(bindjoin, "bindjoin_grouped_plain", broken)
    res = run(CELLS[0])
    assert not res["correct"]
    assert res["checks"]["fragment_mismatches"]["value"] > 0


def test_a_solution_altered_in_the_client_is_caught(monkeypatch):
    from repro_torch.core import client
    inner = client._bind_join

    def broken(*args):
        out = inner(*args)
        return out[:-1] if out.shape[0] > 1 else out

    monkeypatch.setattr(client, "_bind_join", broken)
    res = run(CELLS[0])
    assert not res["correct"]
    assert res["checks"]["solution_mismatches"]["value"] > 0


def test_a_solution_served_twice_is_caught(monkeypatch):
    """The client answers a query with one solution twice. (A row that
    ``_bind_join`` repeats is made distinct again by the client's own
    last step, so the fault is planted in the answer the client
    returns.)"""
    from repro_torch.core.client import AsyncBrTPFClient
    inner = AsyncBrTPFClient._run_pipeline

    async def broken(self, bgp):
        out = await inner(self, bgp)
        return np.concatenate([out, out[:1]]) if out.shape[0] else out

    monkeypatch.setattr(AsyncBrTPFClient, "_run_pipeline", broken)
    res = run(CELLS[0])
    assert not res["correct"]
    assert res["checks"]["solution_mismatches"]["value"] > 0


def test_a_request_never_answered_is_caught(monkeypatch):
    """The front end holds one request for ever: it is unanswered a grace
    period past the close."""
    from repro_torch.core.batching import AsyncBrTPFServer
    inner = AsyncBrTPFServer.handle
    calls = []

    async def broken(self, req):
        calls.append(1)
        if len(calls) == 20:
            await asyncio.Event().wait()
        return await inner(self, req)

    monkeypatch.setattr(AsyncBrTPFServer, "handle", broken)
    res = run(CELLS[0], warmup=0, grace_s=2.0)
    assert not res["correct"]
    assert res["checks"]["unanswered_requests"]["value"] == 1


def test_failed_requests_are_caught(monkeypatch):
    from repro_torch.core.server import BrTPFServer
    inner = BrTPFServer.handle_batch
    calls = []

    def broken(self, reqs):
        calls.append(1)
        if len(calls) % 5 == 0:
            raise RuntimeError("injected")
        return inner(self, reqs)

    monkeypatch.setattr(BrTPFServer, "handle_batch", broken)
    res = run(CELLS[0], warmup=0)
    assert not res["correct"]
    assert res["checks"]["request_errors"]["value"] > 0


def test_without_the_program_the_command_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, the command exits non-zero and prints nothing on stdout."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout == ""


