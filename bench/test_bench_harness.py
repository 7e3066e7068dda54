"""The benchmark's arithmetic and discovery on the CPU: nearest-rank
quantiles and window rates, one launch's roofline operations and bytes,
each cell's configuration, mix and metric files found by name, the
contract's shape of ``BENCHMARK.json``, and what the benchmark imports."""
from __future__ import annotations

import ast
import importlib
import json
import re
from pathlib import Path

import pytest
import torch

from bench import harness, stats
from bench.roofline import common

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_nearest_rank_and_rates():
    values = list(range(1, 101))
    assert stats.nearest_rank(values, 0.95) == 95
    assert stats.nearest_rank(values, 0.5) == 50
    assert stats.nearest_rank([3.0], 0.95) == 3.0
    assert stats.nearest_rank([5, 1, 4, 2, 3], 0.95) == 5
    assert stats.rate(300, 20.0) == 15.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


def test_one_grouped_launch_ops_and_bytes():
    """A launch of the kernel backend: one page, one shard of 700 rows in
    a 1024-wide bucket, 3 groups with 5, 30 and 3 live slots."""
    slots = torch.zeros((3, 32, 4), dtype=torch.int32)
    slots[0, :5, 3] = 1
    slots[1, :30, 3] = 1
    slots[2, 2, 3] = 1
    f = common.facts(torch.zeros((1, 700, 3), dtype=torch.int32), None,
                     slots, torch.zeros(8, dtype=torch.int32), live=30,
                     width=1024,
                     spans=torch.tensor([[[0, 700]]], dtype=torch.int64))
    ops, nbytes = common.work(f)
    assert ops == 6 * 700 + 7 * 700 * 38
    assert nbytes == (12 * 700 + 700 * 3 + 8 * 3 + 16 * 38 + 16 + 32)


def test_one_fused_launch_counts_each_page_against_its_segment():
    """Two pages of four shards with valid flags: the first page's rows
    against segment 0 (3 live slots), the second's against segment 1 (10
    in each of 4 groups); rows past a span, the shard's end or a valid
    flag are not read."""
    valid = torch.ones((4, 5000), dtype=torch.bool)
    valid[:, 4990:] = False
    slots = torch.zeros((2, 4, 32, 4), dtype=torch.int32)
    slots[0, 0, :3, 3] = 1
    slots[1, :, :10, 3] = 1
    spans = torch.tensor([[[0, 1024], [4000, 5000], [0, 0], [10, 20]],
                          [[100, 200], [0, 0], [0, 0], [0, 0]]])
    f = common.facts(torch.zeros((4, 5000, 3), dtype=torch.int32), valid,
                     slots, torch.zeros((2, 8), dtype=torch.int32),
                     spans=spans, width=1024, live=10,
                     seg_of_page=torch.tensor([0, 1], dtype=torch.int32))
    ops, nbytes = common.work(f)
    rows0, rows1 = 1024 + 990 + 10, 100
    assert ops == 6 * (rows0 + rows1) + 7 * (3 * rows0 + 40 * rows1)
    assert nbytes == (13 * (rows0 + rows1) + 4 * (rows0 + rows1)
                      + 8 * 2 * 4 * 4 + 16 * 43 + 16 * 8 + 4 * 2 + 64)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    w, cfg = harness.find_cell(SPEC, cell)
    config = harness.load_json(ROOT / cfg["file"])
    assert config["server"]["selector_backend"] in ("kernel", "sharded")
    assert set(cfg["reduced"]) <= set(config["reduced"])
    mix = harness.load_json(ROOT / "bench" / "mixes"
                            / f"{w['traffic']}.json")
    assert mix["clients"] >= 1 and mix["templates"]
    names = [m["name"] for m in harness.metrics_of(SPEC, cell, True)]
    assert names
    for name, mod in harness.readers(names).items():
        assert callable(mod.read), name
    e2e = [m["name"] for m in harness.metrics_of(SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2


def test_kernel_files_name_wrappers_of_the_port():
    ops = importlib.import_module("repro_torch.kernels.ops")
    kernels = harness.rooflines()
    assert sorted(kernels) == ["bindjoin_fused", "bindjoin_grouped"]
    for mod in kernels.values():
        assert hasattr(getattr(ops, mod.WRAPPER), "launches")
        assert callable(mod.facts) and callable(mod.work)
        assert mod.DEVICE_NAME in mod.__doc__


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m.get("workloads", cells):
            assert m["moves"] in [x["name"] for x in
                                  harness.metrics_of(SPEC, cell, False)]


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package_by_top_level_name():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert files
    for path in files:
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path.name, found)
    # the top-level name is compared whole: the port's begins with the
    # JAX package's
    assert "repro_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "check.py", "rowkeys.py",
                                  "datagen.py", "stats.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in set(_imports(ROOT / "bench" / name))


def test_the_measured_process_check_names_top_level_modules():
    held = ["numpy", "repro_torch", "repro_torch.core", "jaxtyping",
            "reprolib"]
    assert harness.forbidden_modules(held) == []
    assert harness.forbidden_modules(held + ["repro.core", "jax.numpy",
                                             "flax"]) == ["flax", "jax",
                                                          "repro"]
