"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
--smoke [--device cpu]``

Builds a model with random parameters (seed 0), then serves one batch
of generation requests through the KV-cache engine: prefill + greedy
decode. Runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import all_archs, get_arch, reduced_for_smoke
from ..models.model import build_model
from ..serving.engine import ServingEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=sorted(all_archs().keys()))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduced_for_smoke(cfg)
    if cfg.encoder_layers:
        raise SystemExit("enc-dec serving demo: the engine serves "
                         "decoder-only models; an encoder-decoder decodes "
                         "through Model.prefill/decode_step with enc_input")
    model = build_model(cfg, device=args.device)
    engine = ServingEngine(model, max_batch=args.batch,
                           max_seq=args.max_seq)
    dev = engine.device
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            size=rng.integers(4, args.prompt_len + 1))
               .astype(np.int32) for _ in range(args.batch)]
    t0 = time.perf_counter()
    results = engine.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    total_new = sum(r.steps for r in results[:1]) * len(results)
    print(f"[serve] {cfg.name}: batch={args.batch} "
          f"prompt<= {args.prompt_len} new={args.new_tokens}")
    print(f"[serve] {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s on {where})")
    for i, r in enumerate(results):
        print(f"  req{i}: prompt_len={r.prompt_len} "
              f"generated={r.tokens[:8].tolist()}...")


if __name__ == "__main__":
    main()
