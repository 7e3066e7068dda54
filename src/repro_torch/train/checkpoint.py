"""Fault-tolerant checkpointing (the PyTorch counterpart of
``repro.train.checkpoint``, with its layout and contract).

Layout: one directory per step --

    <dir>/step_000123/
        leaf_00000.npy ... leaf_NNNNN.npy (one file per tensor of the tree)
        manifest.json                     (step; per leaf its path, file,
                                           shape, dtype and byte size)
        COMMIT                            (written last: atomicity marker)

A leaf's path is its place in the state tree (``train.tree``): the port's
parameter and optimizer-state names, e.g. ``['params']['embed.tok']``,
``['opt_state'].mu['embed.tok']``, ``['opt_state'].step``.

Fault-tolerance contract:
* writes go to ``step_N.tmp`` and are renamed only after COMMIT exists,
  so a crash mid-write never corrupts the latest valid checkpoint;
* ``latest_step`` skips directories without COMMIT (partial writes);
* ``restore`` verifies each leaf's size against the manifest and falls
  back to the previous valid checkpoint on a mismatch;
* ``AsyncCheckpointer`` copies the tree to host memory (device tensors
  through pinned buffers), then writes it on a background thread while
  training continues (``wait()`` joins);
* ``restore`` puts the tensors on a target ``device`` (the reference's
  ``shardings``: a checkpoint written from one device restores onto
  another, the elastic path on one card).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tree as T

COMMIT_FILE = "COMMIT"


def _numpy(leaf: Any, copy: bool = False) -> np.ndarray:
    """A leaf as a host array; with ``copy``, one that no later in-place
    update of the leaf can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic checkpoint write. Returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest: Dict[str, Any] = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(T.leaves_with_path(tree)):
        arr = _numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "path": path,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "nbytes": int(arr.nbytes),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # commit marker then atomic rename
    with open(os.path.join(tmp, COMMIT_FILE), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def valid_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, COMMIT_FILE)):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = valid_steps(directory)
    return steps[-1] if steps else None


class CheckpointCorrupt(RuntimeError):
    pass


def _restore_one(directory: str, step: int, tree_like: Any,
                 device: Optional[str]) -> Any:
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = list(T.leaves_with_path(tree_like))
    if len(manifest["leaves"]) != len(like):
        raise CheckpointCorrupt(
            f"leaf count mismatch: ckpt {len(manifest['leaves'])} vs "
            f"tree {len(like)}")
    out = []
    for meta, (leaf_path, leaf) in zip(manifest["leaves"], like,
                                       strict=True):
        if meta["path"] != leaf_path:
            raise CheckpointCorrupt(f"leaf {meta['file']} is "
                                    f"{meta['path']}, the tree has "
                                    f"{leaf_path}")
        fpath = os.path.join(path, meta["file"])
        if (not os.path.exists(fpath)
                or os.path.getsize(fpath) < meta["nbytes"]):
            raise CheckpointCorrupt(f"missing/truncated leaf {fpath}")
        arr = np.load(fpath)
        if list(arr.shape) != meta["shape"]:
            raise CheckpointCorrupt(f"shape mismatch in {fpath}")
        target = (device if device is not None
                  else leaf.device if isinstance(leaf, torch.Tensor)
                  else "cpu")
        out.append(torch.from_numpy(arr).to(target))
    return T.unflatten(tree_like, iter(out))


def restore(directory: str, tree_like: Any, device: Optional[str] = None,
            step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore the requested (default: latest) valid checkpoint, falling
    back to older ones if the newest turns out corrupt. Returns (step,
    tree of tensors shaped as ``tree_like``), each tensor on ``device``
    (default: the device of ``tree_like``'s leaf, the CPU for a leaf
    that is not a tensor)."""
    steps = valid_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    if not steps:
        raise FileNotFoundError(f"no valid checkpoint in {directory}")
    for s in reversed(steps):
        try:
            return s, _restore_one(directory, s, tree_like, device)
        except CheckpointCorrupt:
            continue
    raise CheckpointCorrupt(f"all checkpoints in {directory} corrupt")


def cleanup(directory: str, keep: int = 3) -> None:
    steps = valid_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (one in flight at a time).

    ``save`` copies the tree to host memory before it returns, since the
    train step updates the parameters and moments in place: a tensor on
    a CUDA device into a pinned host buffer (kept for the next save, one
    synchronise for the whole tree), anything else into a fresh array."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self.saved_steps: List[int] = []

    def _snapshot(self, tree: Any) -> Any:
        copies, on_card = [], False
        for path, leaf in T.leaves_with_path(tree):
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                buf = self._pinned.get(path)
                if (buf is None or buf.shape != leaf.shape
                        or buf.dtype != leaf.dtype):
                    buf = self._pinned[path] = torch.empty(
                        leaf.shape, dtype=leaf.dtype, pin_memory=True)
                buf.copy_(leaf.detach(), non_blocking=True)
                copies.append(buf)
                on_card = True
            else:
                copies.append(_numpy(leaf, copy=True))
        if on_card:
            torch.cuda.synchronize()
        return T.unflatten(tree, (c.numpy() if isinstance(c, torch.Tensor)
                                  else c for c in copies))

    def save(self, step: int, tree: Any) -> None:
        self.wait()   # the writer is done with the pinned buffers
        host_tree = self._snapshot(tree)

        def work():
            try:
                save(self.directory, step, host_tree)
                cleanup(self.directory, self.keep)
                self.saved_steps.append(step)
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error
