"""Deterministic synthetic data (numpy-seeded, torch tensors).

Streams are a pure function of (seed, step), so every worker re-derives
its shard without coordination, resumption after a restore is exact, and
the values equal the reference's ``SyntheticText`` / ``SyntheticCIFAR``
batch for batch.  Tokens and labels are int64 tensors on the CPU (the
reference's are int32, equal in value), images NHWC float32; a runtime
moves them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape


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


@dataclasses.dataclass(frozen=True)
class SyntheticCIFAR:
    batch_size: int
    num_classes: int = 10
    seed: int = 0

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step))
        labels = rng.integers(0, self.num_classes,
                              size=(self.batch_size,)).astype(np.int64)
        # class-conditional means => learnable
        base = rng.standard_normal((self.batch_size, 32, 32, 3)) * 0.3
        means = np.linspace(-1, 1, self.num_classes)[labels]
        images = (base + means[:, None, None, None]).astype(np.float32)
        return {"images": torch.from_numpy(images),
                "labels": torch.from_numpy(labels)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def _frontend_pending(cfg: ArchConfig):
    return NotImplementedError(
        f"{cfg.name}: batches for the {cfg.frontend} frontend are not "
        f"ported yet (ROADMAP queue 1 item 13, the frontends)")


def batch_for(cfg: ArchConfig, shape: InputShape, *, step: int = 0,
              seed: int = 0) -> Dict[str, torch.Tensor]:
    """A concrete batch for ``cfg`` at ``shape`` (text architectures; the
    audio and vision frontends raise)."""
    if cfg.frontend != "none":
        raise _frontend_pending(cfg)
    return SyntheticText(cfg.vocab_size, shape.seq_len, shape.global_batch,
                         seed).batch(step)


def make_pipeline(cfg: ArchConfig, shape: InputShape, seed: int = 0):
    if cfg.frontend == "none":
        return SyntheticText(cfg.vocab_size, shape.seq_len,
                             shape.global_batch, seed)
    raise ValueError("streaming pipeline implemented for text archs; "
                     "use batch_for() for stubbed modalities")
