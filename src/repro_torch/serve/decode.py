"""Serving: prefill, then batched decode against the KV caches and
recurrent states.

``prefill`` runs the full-sequence forward (the flash kernel and the
RG-LRU scan on the card) and returns the last position's logits and every
block's cache, the global-attention and latent (MLA) caches grown to
``max_len``;
``build_decode_step`` gives the one-token ``serve_step``;
``batched_generate`` runs both for a batch of same-length prompts.

On a CUDA device ``batched_generate`` decodes through a CUDA graph of the
one-token step (``serve/graphs.py``): a graph a key (config, batch, cache
length ``t + max_new_tokens``, device, and the address and dtype of every
parameter leaf), whose static caches the prefill's are written into.  A
call's first step on a key without a graph runs eagerly as the warm-up,
its second captures, every later step replays.  A call of a single step
whose key has no graph, and every call on the CPU, run the eager loop.

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

from repro_torch import tracing, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.serve import graphs

# called after the prefill (step 0) and after each decode step i (1..K),
# once its next token is chosen, with that step's logits (B, 1, V) and the
# caches.  The logits are the hook's to keep: no later step writes them.
# The caches are the live decode state, which later steps write into (the
# KV caches in place on any device; on the CUDA graph path every leaf):
# clone what is kept across steps.
StepHook = Callable[[int, torch.Tensor, List[Any]], None]


def _grows(kind: str, cache: Any, max_len: int) -> bool:
    if kind == "mla":
        return cache.c.shape[1] < max_len
    return kind == "global_attn" and isinstance(cache, KVCache) \
        and cache.k.shape[1] < max_len


def _empty_caches(cfg: ArchConfig, caches: List[Any], max_len: int
                 ) -> List[Any]:
    """Uninitialised caches of the shapes ``pad_caches`` gives
    ``caches``."""
    def like(kind, cache):
        def one(x):
            if _grows(kind, cache, max_len) and x.dim():
                return x.new_empty((x.shape[0], max_len, *x.shape[2:]))
            return torch.empty_like(x)
        return tree.tree_map(one, cache)
    return [like(kind, c) for kind, c in zip(cfg.layer_kinds(), caches)]


def pad_caches(cfg: ArchConfig, caches: List[Any], max_len: int,
               out: Optional[List[Any]] = None) -> List[Any]:
    """Grow global-attention KV caches and latent caches to max_len
    (decode writes past t).
    A local cache keeps the prefill's ``window`` slots.  With ``out``
    (``_empty_caches``' shapes) every leaf is written into ``out``'s
    instead, a grown cache's tail zeroed as ``F.pad`` zeroes it, and
    ``out`` is returned."""
    if out is not None:
        for x, y in zip(tree.leaves(caches), tree.leaves(out)):
            if x.shape == y.shape:
                y.copy_(x)
            else:
                y[:, :x.shape[1]].copy_(x)
                y[:, x.shape[1]:].zero_()
        return out
    grown = []
    for kind, c in zip(cfg.layer_kinds(), caches):
        if _grows(kind, c, max_len) and kind == "mla":
            pad = (0, 0, 0, max_len - c.c.shape[1])        # (B, S, width)
            c = MLACache(c=F.pad(c.c, pad), k_pe=F.pad(c.k_pe, pad),
                         pos=c.pos)
        elif _grows(kind, c, max_len):
            pad = (0, 0, 0, 0, 0, max_len - c.k.shape[1])  # (B, S, H, hd)
            c = KVCache(k=F.pad(c.k, pad), v=F.pad(c.v, pad), pos=c.pos)
        grown.append(c)
    return grown


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
        max_len = prompts.shape[1] + max_new_tokens
        logits, caches = prefill(cfg, params, {"tokens": prompts})
        graph = graphs.lookup(cfg, params, prompts, max_new_tokens,
                              lambda: _empty_caches(cfg, caches, max_len))
        caches = pad_caches(cfg, caches, max_len,
                            out=None if graph is None else graph.start())
        if on_step is not None:
            on_step(0, logits, caches)
        step = build_decode_step(cfg)
        tokens = []
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        # prefill cached t tokens; decode continues from position t
        for i in range(max_new_tokens):
            tokens.append(cur)
            with tracing.span("serve.decode_step"):
                if graph is None:
                    logits, caches = step(params, cur, caches)
                else:
                    logits = graph.step(cfg, params, cur)
                if greedy or generator is None:
                    cur = torch.argmax(logits[:, -1], dim=-1)
                else:
                    cur = sample(logits[:, -1], generator)
                cur = cur[:, None].to(torch.int32)
            if on_step is not None:
                on_step(i + 1, logits if graph is None else logits.clone(),
                        caches)
        return torch.cat(tokens, dim=1)
