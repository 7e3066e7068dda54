"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

* Every module of ``repro_torch`` imports in a fresh interpreter where
  ``jax`` is blocked and a meta-path finder refuses ``repro`` and
  ``repro.*`` (but not ``repro_torch``).
* No source of the port, and not ``chip_smoke.py``, names ``jax`` or
  ``repro`` in an import statement.
* The entry points run on CUDA unless the caller asks for the CPU: on a
  machine without a CUDA device they raise.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"repro_torch must not import {name}")
        return None

sys.modules["jax"] = None
sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" and sys.modules[m] is not None
             or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print(" ".join(names))
"""

# The modules of the training slice, each of which the blocked import
# above must reach.
TRAINING_MODULES = {
    "repro_torch.data.pipeline", "repro_torch.launch.steps",
    "repro_torch.launch.train", "repro_torch.models.mamba",
    "repro_torch.models.rwkv", "repro_torch.train.checkpoint",
    "repro_torch.train.grad_compress", "repro_torch.train.loop",
    "repro_torch.train.optimizer", "repro_torch.train.tree"}

# The static analyzer's 14 modules (host-only, pure ``ast``).
ANALYSIS_MODULES = {"repro_torch.analysis"} | {
    f"repro_torch.analysis.{name}" for name in (
        "__main__", "callgraph", "engine", "findings", "static_eval",
        "rules", "rules.accounting", "rules.async_safety",
        "rules.cache_coherence", "rules.cuda_launch", "rules.dead_code",
        "rules.kernel_launch", "rules.resilience")}


# The sharding layer and the dry-run launchers.
SHARDING_MODULES = {
    "repro_torch.sharding", "repro_torch.sharding.rules",
    "repro_torch.models.axes", "repro_torch.launch.mesh",
    "repro_torch.launch.specs", "repro_torch.launch.roofline",
    "repro_torch.launch.dryrun", "repro_torch.launch.engine_dryrun"}


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=False)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20                     # every module was imported
    assert TRAINING_MODULES <= names
    assert len(ANALYSIS_MODULES) == 14 and ANALYSIS_MODULES <= names
    assert SHARDING_MODULES <= names


def _forbidden_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                yield f"{path.relative_to(ROOT)}:{node.lineno}: {name}"


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert all(f.is_file() for f in files)
    bad = [hit for f in files for hit in _forbidden_imports(f)]
    assert bad == []


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core import BrTPFServer, ServerConfig, TripleStore
    from repro_torch.core.kernel_selectors import KernelSelector
    store = TripleStore(np.array([[1, 2, 3]], np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelSelector(store)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BrTPFServer(store, ServerConfig(selector_backend="kernel"))
    from repro_torch.core.federation import FederatedStore
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BrTPFServer(store, ServerConfig(selector_backend="sharded"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedStore.build(store.triples, 4, device=None)
    assert FederatedStore.build(store.triples, 4,
                                device="cpu").device.type == "cpu"
    assert KernelSelector(store, device="cpu").device.type == "cpu"
    # the numpy oracle needs no device
    assert BrTPFServer(store, ServerConfig())._selector is None
    # the serving edge builds its servers through the same path
    from repro_torch.core import AsyncBrTPFServer
    from repro_torch.serving.http import app_from_config
    from repro_torch.serving.router import ReplicaRouter
    kcfg = ServerConfig(selector_backend="kernel")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app_from_config(store, kcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        app_from_config(store, kcfg, replicas=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AsyncBrTPFServer.from_config(store, kcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRouter(store, kcfg, replicas=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaRouter(store, ServerConfig(selector_backend="sharded",
                                          shards=2), replicas=2)
    assert ReplicaRouter(store, kcfg.replace(device="cpu"), replicas=2) \
        .replicas[1].server._selector.device.type == "cpu"
    # the LM serving path: the model, its engine, the weight converter
    # and the serve CLI
    from repro_torch.configs import get_arch, reduced_for_smoke
    from repro_torch.launch import serve
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServingEngine
    cfg = reduced_for_smoke(get_arch("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(build_model(cfg), max_batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(cfg, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2-1.5b", "--smoke"])
    assert ServingEngine(build_model(cfg, device="cpu"), max_batch=1,
                         max_seq=8).device.type == "cpu"
    # the training path: every family's model, and the train CLI
    from repro_torch.configs import all_archs
    from repro_torch.launch import train
    for arch in all_archs():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(reduced_for_smoke(get_arch(arch)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "rwkv6-7b", "--smoke", "--steps", "1"])
    # the dry-run launchers trace fake CUDA tensors unless asked for the
    # CPU, and the fake process group does not outlive them
    import torch.distributed as dist
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.engine_dryrun import lower_variant
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_cell("qwen2-1.5b", "decode_32k", False, mini=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lower_variant("windowed")
    assert trace_cell("qwen2-1.5b", "decode_32k", False, mini=True,
                      device="cpu")["device"] == "cpu"
    assert not dist.is_initialized()
