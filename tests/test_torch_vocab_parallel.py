"""The port's vocab-parallel cross-entropy (``models.model.vocab_parallel_nll``,
the NLL ``Model.loss`` takes of DTensor logits) on the CPU.

* Values and gradients: 4 gloo processes hold float32 logits over a
  full-size vocabulary (151,936, qwen2-1.5b's) sharded as the rules shard
  them, on a (data 2, model 2) and a (pod 2, data 1, model 2) mesh; the
  per-position NLL and the gradient of a weighted sum of it equal
  ``F.log_softmax`` + ``gather`` and ``jax.nn.log_softmax`` +
  ``take_along_axis`` (``jax.grad``) on one process. The gradient comes
  back sharded as the logits are, and no rank gathers the vocabulary.
* The dry-run: the mini qwen2 config at that vocabulary on mini2x2
  (grad_accum 2) and mini2x2x2 (grad_accum 1), the same 2-row
  microbatch on both, lists no ``_log_softmax`` redistribution and no
  full-vocabulary all-gather, and rank 0's temporaries stay within 1.10x
  of each other and below a bound set by the sharded logits.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import dryrun as D
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 151936
B, S = 4, 8
MESHES = ["2x2", "2x1x2"]
# float32: the shards' sums of exponentials add in another order than
# one process's (about 1e-7 of a value); held elementwise, so the
# gradient's softmax entries (about 1/V) are held to their own size.
RTOL, ATOL = 1e-5, 1e-12

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import roofline as RL
from repro_torch.models.model import vocab_parallel_nll
from repro_torch.sharding.rules import (default_rules, guard,
                                        placements_for, spec_for, use_rules)

rank, init, out, inputs = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method=init, world_size=4, rank=rank)
try:
    data = np.load(inputs)
    res = {}
    for key in sys.argv[5:]:
        shape = tuple(int(n) for n in key.split("x"))
        names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                           "model")
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        rules = default_rules(multi_pod=len(shape) == 3)

        def place(a, axes):
            pl = placements_for(guard(spec_for(axes, rules), a.shape, mesh),
                                mesh)
            return distribute_tensor(torch.from_numpy(a), mesh, pl)

        x = place(data["logits"], ("batch", "seq", "vocab")).requires_grad_()
        tgt = place(data["targets"], ("batch", "seq"))
        counter = RL.CostCounter(RL.group_names(mesh))
        with use_rules(mesh, rules), implicit_replication(), counter:
            nll = vocab_parallel_nll(x, tgt)
            (nll * torch.from_numpy(data["weights"])).sum().backward()
        res[key + "/nll"] = nll.full_tensor().detach().numpy()
        res[key + "/grad"] = x.grad.full_tensor().numpy()
        res[key + "/grad_sharded"] = np.asarray(
            tuple(x.grad.placements) == tuple(x.placements)
            and x.grad.to_local().shape == x.to_local().shape)
        res[key + "/local_vocab"] = np.asarray(x.to_local().shape[-1])
        res[key + "/gathered"] = np.asarray(sum(
            kinds.get("all-gather", 0.0)
            for kinds in counter.coll_by_op.values()))
        res[key + "/coll_bytes"] = np.asarray(sum(counter.coll_bytes.values()))
    if rank == 0:
        np.savez(out, **res)
finally:
    dist.destroy_process_group()
"""


def _inputs():
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.normal(size=(B, S, VOCAB))).astype(np.float32)
    targets = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    # the vocabulary's ends and the two shards' boundary
    targets[0, :4] = [0, VOCAB // 2 - 1, VOCAB // 2, VOCAB - 1]
    weights = rng.normal(size=(B, S)).astype(np.float32)
    return logits, targets, weights


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab_gloo")
    logits, targets, weights = _inputs()
    np.savez(tmp / "inputs.npz", logits=logits, targets=targets,
             weights=weights)
    out = tmp / "rank0.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), f"file://{tmp}/pg", str(out),
         str(tmp / "inputs.npz")] + MESHES, env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    return dict(np.load(out))


def _torch_reference():
    logits, targets, weights = _inputs()
    x = torch.from_numpy(logits).requires_grad_()
    logp = F.log_softmax(x, dim=-1)
    nll = -torch.gather(logp, -1, torch.from_numpy(targets)[..., None]
                        .long())[..., 0]
    (nll * torch.from_numpy(weights)).sum().backward()
    return nll.detach().numpy(), x.grad.numpy()


def _jax_reference():
    logits, targets, weights = _inputs()

    def nll_fn(x):
        logp = jax.nn.log_softmax(x, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                                    axis=-1)[..., 0]

    nll = nll_fn(jnp.asarray(logits))
    grad = jax.grad(lambda x: (nll_fn(x) * weights).sum())(
        jnp.asarray(logits))
    return np.asarray(nll), np.asarray(grad)


@pytest.mark.parametrize("reference", ["torch", "jax"])
@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_nll_equals_log_softmax(mesh, reference, sharded):
    want_nll, want_grad = (_torch_reference if reference == "torch"
                           else _jax_reference)()
    np.testing.assert_allclose(sharded[mesh + "/nll"], want_nll, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(sharded[mesh + "/grad"], want_grad,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_nll_keeps_the_vocabulary_sharded(mesh, sharded):
    """Each rank holds half the vocabulary, its gradient comes back so,
    and the only collectives are the per-position max and sums."""
    assert int(sharded[mesh + "/local_vocab"]) == VOCAB // 2
    assert bool(sharded[mesh + "/grad_sharded"])
    assert float(sharded[mesh + "/gathered"]) == 0.0
    # all-reduces of rank 0's positions (its half of the batch): the
    # float32 max, then the float64 (sum of exponentials, target logit)
    positions = B * S // 2
    assert float(sharded[mesh + "/coll_bytes"]) == positions * (4 + 2 * 8)


# -- the dry-run at a full-size vocabulary ---------------------------------------

MINI_CELLS = {"mini2x2": (False, 2), "mini2x2x2": (True, 1)}


@pytest.fixture(scope="module")
def mini_traces():
    cfg, shape = D.cell_config("qwen2-1.5b", "train_4k", True)
    cfg = dataclasses.replace(cfg, vocab_size=VOCAB)
    dev = resolve_device("cpu")
    out = {name: D._trace(cfg, shape, multi_pod, True, dev, "train", accum)
           for name, (multi_pod, accum) in MINI_CELLS.items()}
    return cfg, shape, out


def _sharded_logits_bytes(cfg, shape, rec):
    """Rank 0's float32 logits of one CE chunk over its vocabulary shard:
    microbatch rows x chunk x V / model x 4 bytes."""
    data = rec["chips"] // 2            # the model axis is 2 wide
    rows = shape.global_batch // rec["grad_accum"] // data
    chunk = Model.CE_CHUNK if shape.seq_len % Model.CE_CHUNK == 0 \
        else shape.seq_len
    return rows * chunk * cfg.vocab_size // 2 * 4


@pytest.mark.parametrize("mesh", list(MINI_CELLS))
def test_mini_dryrun_gathers_no_vocabulary(mesh, mini_traces):
    cfg, shape, traces = mini_traces
    rec = traces[mesh]
    assert "_log_softmax" not in rec["redistributed"]
    full_vocab = 2 * _sharded_logits_bytes(cfg, shape, rec)
    for op, kinds in rec["redistributed"].items():
        assert kinds.get("all-gather", 0.0) < full_vocab, op


@pytest.mark.parametrize("mesh", list(MINI_CELLS))
def test_mini_dryrun_temporaries_below_the_sharded_logits_bound(
        mesh, mini_traces):
    """The CE sets the mini model's peak, in its backward: the shard's
    saved ``x - max`` (float32, 1x the sharded logits), the float64
    gradient (2x) and its float32 rounding (1x); the rest of the model
    is small: the bound is 4.5x. With the vocabulary gathered (each
    rank's float32 logits and their gradient whole) the same trace
    needed 15x."""
    cfg, shape, traces = mini_traces
    rec = traces[mesh]
    assert rec["temp"] < 4.5 * _sharded_logits_bytes(cfg, shape, rec)


def test_mini_dryrun_two_pod_within_one_pod(mini_traces):
    _, _, traces = mini_traces
    a, b = traces["mini2x2"]["temp"], traces["mini2x2x2"]["temp"]
    assert max(a, b) <= 1.10 * min(a, b)
