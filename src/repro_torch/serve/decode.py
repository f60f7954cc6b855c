"""Serving: prefill, then batched decode against the KV caches and
recurrent states.

``prefill`` runs the full-sequence forward (the flash kernel and the
RG-LRU scan on the card) and returns the last position's logits and every
block's cache, the global-attention caches grown to ``max_len``;
``build_decode_step`` gives the one-token ``serve_step``;
``batched_generate`` runs both for a batch of same-length prompts.

Departures from the reference, by design:

* the whole loop runs under ``torch.inference_mode()`` and the KV caches
  are written in place (``models/attention.py``): the reference's XLA
  copies them a step;
* sampling (``greedy=False``) cannot replay ``jax.random.categorical``: it
  takes the same method, Gumbel-max (``argmax(logits + G)``, ``G =
  -log(-log(U))``), with ``U`` drawn from an explicit ``torch.Generator``
  on the logits' device.

Nothing in the loop reads a device value on the host: the next token is
the device's ``argmax``, so a decode step never synchronises the stream.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.models.attention import KVCache

# called after the prefill (step 0) and after each decode step i (1..K),
# once its next token is chosen, with that step's logits (B, 1, V) and the
# caches
StepHook = Callable[[int, torch.Tensor, List[Any]], None]


def pad_caches(cfg: ArchConfig, caches: List[Any], max_len: int
               ) -> List[Any]:
    """Grow global-attention KV caches to max_len (decode writes past t).
    A local cache keeps the prefill's ``window`` slots."""
    out = []
    for kind, c in zip(cfg.layer_kinds(), caches):
        if kind == "global_attn" and isinstance(c, KVCache) \
                and c.k.shape[1] < max_len:
            pad = (0, 0, 0, 0, 0, max_len - c.k.shape[1])
            c = KVCache(k=F.pad(c.k, pad), v=F.pad(c.v, pad), pos=c.pos)
        out.append(c)
    return out


def prefill(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, List[Any]]:
    """Returns (last-position logits, caches sized for max_len decode)."""
    logits, caches, _ = model_lib.forward(cfg, params, batch, mode="prefill",
                                          last_only=True)
    if max_len is not None:
        caches = pad_caches(cfg, caches, max_len)
    return logits, caches


def build_decode_step(cfg: ArchConfig):
    def serve_step(params, token, caches):
        return model_lib.decode_step(cfg, params, token, caches)
    return serve_step


def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw a row of ``softmax(logits)`` (B, V) by Gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def batched_generate(cfg: ArchConfig, params, prompts: torch.Tensor, *,
                     max_new_tokens: int, greedy: bool = True,
                     generator: Optional[torch.Generator] = None,
                     on_step: Optional[StepHook] = None) -> torch.Tensor:
    """Generate continuations (B, max_new_tokens) int32 for a batch of
    same-length prompts (B, T)."""
    with torch.inference_mode():
        t = prompts.shape[1]
        logits, caches = prefill(cfg, params, {"tokens": prompts},
                                 max_len=t + max_new_tokens)
        if on_step is not None:
            on_step(0, logits, caches)
        step = build_decode_step(cfg)
        tokens = []
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        # prefill cached t tokens; decode continues from position t
        for i in range(max_new_tokens):
            tokens.append(cur)
            with tracing.span("serve.decode_step"):
                logits, caches = step(params, cur, caches)
                if greedy or generator is None:
                    cur = torch.argmax(logits[:, -1], dim=-1)
                else:
                    cur = sample(logits[:, -1], generator)
                cur = cur[:, None].to(torch.int32)
            if on_step is not None:
                on_step(i + 1, logits, caches)
        return torch.cat(tokens, dim=1)
