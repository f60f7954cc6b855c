"""Deterministic synthetic text batches (numpy-seeded, torch tensors).

Streams are a pure function of (seed, step), so every worker re-derives
its shard without coordination, resumption after a restore is exact, and
the values equal the reference's ``SyntheticText`` batch for batch.
Tokens and labels are int64 tensors on the CPU; a runtime moves them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticText:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step))
        # zipf-ish marginal over the vocab
        ranks = np.arange(1, self.vocab_size + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(self.vocab_size, size=(self.batch_size, self.seq_len),
                          p=probs).astype(np.int64)
        # learnable structure: label_t = perm[token_t]
        perm = np.random.default_rng(self.seed).permutation(self.vocab_size)
        labels = perm[toks].astype(np.int64)
        return {"tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
