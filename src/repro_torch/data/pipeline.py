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
from repro_torch.models import frontend


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


def batch_for(cfg: ArchConfig, shape: InputShape, *, step: int = 0,
              seed: int = 0) -> Dict[str, torch.Tensor]:
    """A concrete batch for ``cfg`` at ``shape``: text, stub audio frames
    with zero labels, or stub vision embeddings (at most ``t - 1`` of them)
    before ``t - nv`` text tokens.  The stubs come from
    ``models/frontend.py``, equal to the reference's in shape and scale,
    not in value."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio":
        return {"frames": frontend.audio_frames(cfg, b, t, seed=seed),
                "labels": torch.zeros((b, t), dtype=torch.int64)}
    if cfg.frontend == "vision":
        nv = min(cfg.num_vision_tokens, t - 1)
        text = SyntheticText(cfg.vocab_size, t - nv, b, seed).batch(step)
        return {"tokens": text["tokens"],
                "vision_embeds": frontend.vision_embeddings(
                    cfg, b, seed=seed)[:, :nv],
                "labels": text["labels"]}
    return SyntheticText(cfg.vocab_size, t, b, seed).batch(step)


def make_pipeline(cfg: ArchConfig, shape: InputShape, seed: int = 0):
    if cfg.frontend == "none":
        return SyntheticText(cfg.vocab_size, shape.seq_len,
                             shape.global_batch, seed)
    raise ValueError("streaming pipeline implemented for text archs; "
                     "use batch_for() for stubbed modalities")
