"""Batched serving engine: prefill + greedy decode with a KV cache (the
PyTorch counterpart of ``repro.serving.engine``).

Fixed-size batch slots, prompts left-padded with token 0 to a common
length (the pads are attended to, as in the reference), greedy argmax
(the first index on ties, as ``jnp.argmax``), and an early stop once
every request has emitted ``eos_id``. The cache is preallocated at
``max_seq`` and updated in place by each decode step. It serves every
decoder-only family (attention, RWKV, the Mamba hybrid); an
encoder-decoder needs ``enc_input``, which ``generate`` does not take,
as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.model import Model


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [new_tokens]
    prompt_len: int
    steps: int


class ServingEngine:
    def __init__(self, model: Model, max_batch: int, max_seq: int,
                 eos_id: Optional[int] = None) -> None:
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id

    @property
    def device(self) -> torch.device:
        """Where the model's parameters, and so the batch, live."""
        return self.model.norm_f.device

    @torch.inference_mode()
    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 32) -> List[GenerationResult]:
        """Greedy generation for a batch of prompts (left-padded to a
        common length; right side reserved for generation)."""
        if not 0 < len(prompts) <= self.max_batch:
            raise ValueError(f"{len(prompts)} prompts for "
                             f"{self.max_batch} batch slots")
        b = self.max_batch
        plen = max(len(p) for p in prompts)
        if plen + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt {plen} + {max_new_tokens} new tokens "
                             f"exceed max_seq {self.max_seq}")
        toks = np.zeros((b, plen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p  # left pad with 0

        logits, cache = self.model.prefill(
            torch.as_tensor(toks, device=self.device), max_seq=self.max_seq)
        next_tok = torch.argmax(logits[:, -1], dim=-1)

        out = np.zeros((b, max_new_tokens), np.int32)
        pos = plen
        for step in range(max_new_tokens):
            out[:, step] = next_tok.cpu().numpy()
            logits, cache = self.model.decode_step(cache, next_tok[:, None],
                                                   pos)
            next_tok = torch.argmax(logits[:, -1], dim=-1)
            pos += 1
            if (self.eos_id is not None
                    and bool((out[: len(prompts), : step + 1]
                              == self.eos_id).any(axis=1).all())):
                break

        results = []
        for i, p in enumerate(prompts):
            gen = out[i]
            if self.eos_id is not None:
                hits = np.nonzero(gen == self.eos_id)[0]
                if hits.size:
                    gen = gen[: hits[0] + 1]
            results.append(GenerationResult(tokens=gen,
                                            prompt_len=len(p),
                                            steps=pos - plen))
        return results
