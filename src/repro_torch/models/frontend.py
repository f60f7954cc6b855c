"""Modality frontend stubs: deterministic embeddings of the right shape.

The [audio] and [vlm] architectures specify the transformer backbone only;
the ViT / SigLIP tower and the mel / conv feature extractor are stubs, as
in the reference (``repro/models/frontend.py``): the same shapes and the
same scale (``N(0, 1) · 0.02``).  The reference draws from
``jax.random.PRNGKey(seed)``, which torch cannot replay, so the values
here come from a CPU ``torch.Generator`` seeded with ``seed``: equal in
distribution, not in value.  A parity check carries the reference's arrays
across instead.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def _normal(shape, seed: int, dtype) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32
                       ).to(dtype) * 0.02


def vision_embeddings(cfg: ArchConfig, batch: int, *, seed: int = 0,
                      dtype=torch.float32) -> torch.Tensor:
    """Stub anyres patch embeddings: (B, num_vision_tokens, d_model)."""
    return _normal((batch, cfg.num_vision_tokens, cfg.d_model), seed, dtype)


def audio_frames(cfg: ArchConfig, batch: int, num_frames: int, *,
                 seed: int = 0, dtype=torch.float32) -> torch.Tensor:
    """Stub conv-extracted frame embeddings: (B, T, d_model)."""
    return _normal((batch, num_frames, cfg.d_model), seed, dtype)
