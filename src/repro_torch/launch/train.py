"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu] ...``

Runs any registered architecture (reduced with ``--smoke``, or at full
size) through the training runtime: the brTPF data plane selects the
documents -> train step -> AdamW -> async checkpoints with failure
recovery; it resumes from the latest checkpoint in ``--ckpt-dir``. Runs
on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import all_archs, get_arch, reduced_for_smoke
from ..data.pipeline import BrTPFDataPipeline, SyntheticCorpus
from ..launch.steps import make_train_step
from ..models.model import build_model
from ..train.loop import Trainer, TrainerConfig
from ..train.optimizer import AdamW, warmup_cosine

# Frames of the stub encoder input of an encoder-decoder model.
ENC_FRAMES = 8
CKPT_EVERY = 25


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=sorted(all_archs().keys()))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--selection",
                    default="?d hasDomain code\n?d hasQuality q0")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg)
    model = build_model(cfg, device=args.device)
    dev = model.norm_f.device
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")

    corpus = SyntheticCorpus.generate(
        num_docs=300, vocab_size=cfg.vocab_size, seed=0)
    pipe = BrTPFDataPipeline(corpus, args.selection,
                             batch_size=args.batch, seq_len=args.seq)
    print(f"[data] brTPF selection: {pipe.stats.selected_docs} docs, "
          f"{pipe.stats.num_requests} requests")

    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 10, args.steps))
    step_fn = make_train_step(model, opt)

    def batches():
        for b in pipe:
            batch = {k: torch.as_tensor(v.astype(np.int64), device=dev)
                     for k, v in b.items()}
            if cfg.encoder_layers:
                batch["enc_input"] = torch.as_tensor(
                    np.random.default_rng(0).normal(
                        size=(args.batch, ENC_FRAMES, cfg.d_model)),
                    dtype=torch.float32, device=dev)
            yield batch

    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_{cfg.name}")
    trainer = Trainer(TrainerConfig(total_steps=args.steps,
                                    ckpt_dir=ckpt_dir,
                                    ckpt_every=CKPT_EVERY),
                      step_fn, params, opt.init(params))
    if trainer.try_resume():
        print(f"[ckpt] resumed at step {trainer.step}")
    report = trainer.train(batches())
    if not report.losses:
        print(f"[done] steps=0 restarts={report.restarts} (the checkpoint "
              f"is at step {trainer.step} of {args.steps})")
        return
    print(f"[done] steps={report.steps_run} restarts={report.restarts} "
          f"loss {report.losses[0]:.3f} -> {report.final_loss:.3f}")


if __name__ == "__main__":
    main()
