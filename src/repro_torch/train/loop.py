"""The training loop: checkpoint/restart, failure recovery, stragglers
(the PyTorch counterpart of ``repro.train.loop``).

Fault-tolerance model, as in the reference:
* **checkpoint/restart** -- async checkpoints every ``ckpt_every``
  steps; on any step failure the trainer restores the latest valid
  checkpoint and replays from there (up to ``max_restarts``).
* **node failure** -- a device failure surfaces as an exception from
  the step function; the same restore-and-replay path handles it.
  ``failure_hook`` lets tests raise mid-run to exercise this.
* **straggler mitigation** -- steps slower than ``straggler_factor`` x
  the rolling median of the last 32 (counted from the 8th step) are
  counted and reported to ``on_straggler``. On one host this is
  advisory only.
* **elastic scaling** -- checkpoints are device-independent (host numpy
  + manifest), so ``Trainer.restore_onto`` can restore the state onto
  another device.

The state is ``params`` (a dict of the model's parameters by name) and
``opt_state``, which the step function updates in place and returns. A
restore writes the checkpoint's values into those same tensors (their
``.data``), so the model that owns the parameters trains on from the
restored values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from . import checkpoint as ckpt
from . import tree as T


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    ckpt_keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclasses.dataclass
class TrainerReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: List[float] = dataclasses.field(default_factory=list)
    final_loss: float = float("nan")


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 params: Any, opt_state: Any,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 on_straggler: Optional[Callable[[int, float],
                                                 None]] = None) -> None:
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.failure_hook = failure_hook
        self.on_straggler = on_straggler
        self.checkpointer = ckpt.AsyncCheckpointer(cfg.ckpt_dir,
                                                   keep=cfg.ckpt_keep)
        self.step = 0

    # -- checkpoint/restart ----------------------------------------------------

    def _state_tree(self) -> Dict[str, Any]:
        return {"params": self.params, "opt_state": self.opt_state}

    @torch.no_grad()
    def _load(self, step: int, tree: Dict[str, Any]) -> None:
        for dst, src in zip(T.leaves(self._state_tree()), T.leaves(tree),
                            strict=True):
            dst.data = src
        self.step = step

    def try_resume(self, device: Optional[str] = None) -> bool:
        """Restore the latest valid checkpoint, if there is one (onto
        ``device``, default: where the state lives)."""
        if ckpt.latest_step(self.cfg.ckpt_dir) is None:
            return False
        self._load(*ckpt.restore(self.cfg.ckpt_dir, self._state_tree(),
                                 device))
        return True

    def restore_onto(self, device: str) -> None:
        """Elastic path: restore the latest checkpoint onto ``device``,
        moving the state there."""
        self._load(*ckpt.restore(self.cfg.ckpt_dir, self._state_tree(),
                                 device))

    # -- the loop ----------------------------------------------------------------

    def train(self, data_iter: Iterator[Dict[str, Any]]) -> TrainerReport:
        report = TrainerReport()
        cfg = self.cfg
        durations: List[float] = []
        restarts = 0

        while self.step < cfg.total_steps:
            try:
                batch = next(data_iter)
                if self.failure_hook is not None:
                    self.failure_hook(self.step)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])   # the step's synchronise
                dt = time.perf_counter() - t0

                # straggler detection against the rolling median
                durations.append(dt)
                if len(durations) >= 8:
                    med = float(np.median(durations[-32:]))
                    if dt > cfg.straggler_factor * med:
                        report.stragglers += 1
                        if self.on_straggler is not None:
                            self.on_straggler(self.step, dt)

                self.step += 1
                report.steps_run += 1
                report.losses.append(loss)
                report.final_loss = loss

                if self.step % cfg.ckpt_every == 0:
                    self.checkpointer.save(self.step, self._state_tree())
            except (StopIteration, KeyboardInterrupt):
                break
            except Exception:
                restarts += 1
                report.restarts = restarts
                if restarts > cfg.max_restarts:
                    raise
                # failure recovery: restore the latest valid checkpoint;
                # with none yet, go on from the current state
                self.checkpointer.wait()
                self.try_resume()

        self.checkpointer.wait()
        return report
