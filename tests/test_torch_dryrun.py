"""The port's dry-run launchers and its sharded program on the CPU.

* ``python -m repro_torch.launch.dryrun --mini --device cpu`` exits 0 for
  the five archs of the reference's mini dry-run test on the (2, 2) mesh
  and for qwen2-1.5b on (2, 2, 2), where the reference's own run fails
  (``ShardingTypeError`` in its embedding lookup). Subprocesses: the fake
  process group never meets another test's.

* qwen2-1.5b's prefill at ``reduced_for_smoke``, global batch 32, traced
  in process on fake gpu32x8 and gpu2x32x8 meshes: the two-pod mesh
  shards the 32 rows over ``data`` (64 pod x data ranks do not divide
  them), so its per-device bytes stay within chip_smoke.py's
  ``POD_RATIO_LIMIT`` of one pod's.

The sharded program's numerical parity with one process is in
``test_torch_sharding.py``.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# the reference test's: one dense GQA, one MoE, the hybrid, the SSM and
# the encoder-decoder family
ARCHS = ["qwen2-1.5b", "olmoe-1b-7b", "jamba-1.5-large-398b", "rwkv6-7b",
         "seamless-m4t-medium"]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _dryrun(args, out, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mini",
         "--device", "cpu", "--out", str(out)] + args,
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=ROOT)


def _check_grads(rec):
    """A train step's record names its largest parameter gradient, and
    none is held above the shard its rules give (jamba's data-sharded
    parameters included); an inference step forms none."""
    blocks = rec["grad_blocks"]
    if rec["kind"] != "train":
        assert blocks is None
        return
    assert blocks["largest"]["bytes"] > 0 and blocks["largest"]["leaf"]
    assert blocks["above_shard"] == [], blocks["above_shard"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mini_dryrun_single_pod(arch, tmp_path):
    r = _dryrun(["--arch", arch], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "FAILED" not in r.stdout
    recs = [json.loads(p.read_text()) for p in tmp_path.glob(
        f"{arch}__*__mini2x2.json")]
    assert {r["shape"] for r in recs} >= {"train_4k", "prefill_32k",
                                          "decode_32k"}
    for rec in recs:
        roof = rec["roofline"]
        assert rec["chips"] == 4 and rec["device"] == "cpu"
        assert roof["flops_per_chip"] > 0 and roof["bytes_per_chip"] > 0
        assert rec["memory_analysis"]["argument_size_gb"] > 0
        assert roof["dominant"] in ("compute", "memory", "collective")
        _check_grads(rec)
    skips = json.loads((tmp_path / "skips.json").read_text())
    assert {s["arch"] for s in skips} >= {"qwen2-1.5b"}


def test_mini_dryrun_multi_pod(tmp_path):
    """The pod axis shards: the (2, 2, 2) mesh over the same steps."""
    r = _dryrun(["--arch", "qwen2-1.5b", "--multi-pod"], tmp_path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "FAILED" not in r.stdout
    names = os.listdir(tmp_path)
    assert any("train_4k" in n for n in names)
    assert any("decode_32k" in n for n in names)
    rec = json.loads((tmp_path / "qwen2-1.5b__train_4k__mini2x2x2.json")
                     .read_text())
    assert rec["chips"] == 8 and rec["mesh"] == "mini2x2x2"
    # the batch is sharded over pod and data: its gradients are reduced
    # over both, the pod's over InfiniBand
    assert set(rec["roofline"]["coll_bytes_by_dim"]) >= {"pod", "data"}
    _check_grads(rec)


def test_dryrun_needs_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mini",
         "--arch", "qwen2-1.5b", "--shape", "decode_32k", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=_env(), cwd=ROOT)
    assert r.returncode == 1 and "device='cpu'" in r.stdout


def test_grad_blocks_hold_no_parameter_after_exit():
    """``GradBlocks`` records each gradient's bytes against its
    parameter's, and keeps no parameter alive once its block exits: a
    model deleted after the step is freed (rank 0's real runs measure
    each cell's peak from what the previous cells left)."""
    import gc
    import weakref

    from repro_torch.launch.dryrun import GradBlocks
    model = torch.nn.Linear(4, 3)
    ref = weakref.ref(model.weight)
    with GradBlocks(model) as grads:
        model(torch.ones(2, 4)).sum().backward()
    del model
    gc.collect()
    assert ref() is None
    rec = grads.record()
    assert rec["largest"] == dict(leaf="weight", bytes=48, shard_bytes=48,
                                  placements=[], above=[])
    assert rec["above_shard"] == []


def test_two_pod_prefill_shards_its_batch():
    """A batch of 32 on gpu2x32x8 is sharded over data, not replicated:
    rank 0's per-device bytes are within ``POD_RATIO_LIMIT`` of
    gpu32x8's (the whole-entry guard gave 29x)."""
    from repro_torch.configs.base import (ALL_SHAPES, get_arch,
                                          reduced_for_smoke)
    from repro_torch.launch.dryrun import _trace
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = reduced_for_smoke(get_arch("qwen2-1.5b"))
    shape = dataclasses.replace(
        {s.name: s for s in ALL_SHAPES}["prefill_32k"], seq_len=64)
    assert shape.global_batch == 32
    gb = {}
    for multi_pod in (False, True):
        raw = _trace(cfg, shape, multi_pod, False, torch.device("cpu"),
                     "prefill")
        gb[multi_pod] = raw["arg"] + raw["out"] + raw["temp"]
        assert raw["chips"] == (512 if multi_pod else 256)
    assert gb[True] / gb[False] <= smoke.POD_RATIO_LIMIT, gb
