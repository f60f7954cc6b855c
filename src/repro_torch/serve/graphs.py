"""The one-token decode step as a CUDA graph, captured once a key and
replayed for every token.

On a CUDA device ``serve.decode.batched_generate`` replays a captured
graph of ``models.decode_step`` instead of launching its kernels one by
one from Python (~2,900 a granite-3-2b step, which the host, not the
card, paces).  A replay runs the same kernels on the same shapes as the
eager step, so the tokens and the logits are bitwise the eager loop's.

A graph bakes in the address of every tensor it reads and writes, so its
key is what fixes those addresses: the config, the batch, the cache
length (prompt + new tokens), the device, and the address and dtype of
every parameter leaf.  A call whose parameters were replaced, a whole
dict or one leaf, never replays a graph that reads another's memory; it
gets a key of its own.  The store keeps the ``MAX_GRAPHS`` keys used last.

Each key owns static inputs: the token (B, 1) and the caches, into which
each call's prefill caches are written (``decode.pad_caches(..., out=)``).
The step writes its keys and values into them in place, as the eager step
does, and the captured step ends by copying each leaf it made anew (every
``pos + 1``, the recurrent states) back into its static one, where the
next replay reads it.

A call's first decode step on a key without a graph runs eagerly on the
capture stream: the warm-up that capture needs (cuBLAS's handle and
workspace for that stream, the rotary table).  Its second step captures
the step into a private memory pool and replays it; every later step,
in this call or a later one, only replays.  The next token is chosen
outside the graph.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tracing, tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.models.layers import _rope_table

# a server meets a few cache lengths in turn, and each key holds its own
# static caches (GBs at full width): keep the keys used last
MAX_GRAPHS = 4

_store: "collections.OrderedDict[Tuple, DecodeGraph]" = \
    collections.OrderedDict()
_capture_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _key(cfg: ArchConfig, params, batch: int, max_len: int,
         device: torch.device) -> Tuple:
    return (cfg, batch, max_len, device,
            tuple((x.data_ptr(), x.dtype) for x in tree.leaves(params)))


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    return _capture_streams[device]


class DecodeGraph:
    """One key's static token and caches and, once captured, its graph."""

    def __init__(self, cfg: ArchConfig, caches: List[Any], batch: int,
                 device: torch.device):
        self.caches = caches
        self.token = torch.zeros((batch, 1), dtype=torch.int32,
                                 device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None     # the graph's output
        self.warm = False
        # read by address by every attention block: held here, since the
        # cache that owns it may be cleared (``launch/fake.py``)
        self.rope = _rope_table(cfg.head_dim, float(cfg.rope_theta), device)

    def start(self) -> List[Any]:
        """A new call: its prefill caches go into :attr:`caches`."""
        self.warm = False
        return self.caches

    def _run(self, cfg: ArchConfig, params) -> torch.Tensor:
        logits, new = model_lib.decode_step(cfg, params, self.token,
                                            self.caches)
        for static, fresh in zip(tree.leaves(self.caches),
                                 tree.leaves(new)):
            if fresh is not static:
                static.copy_(fresh)
        return logits

    def step(self, cfg: ArchConfig, params,
             token: torch.Tensor) -> torch.Tensor:
        """One decode step from ``token`` (B, 1): its logits (B, 1, V),
        the graph's own output once captured (the next step overwrites
        it)."""
        self.token.copy_(token)
        if self.graph is None:
            current = torch.cuda.current_stream()
            stream = _capture_stream(self.token.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                if not self.warm:
                    logits = self._run(cfg, params)
                    logits.record_stream(current)
                else:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=stream):
                        self.logits = self._run(cfg, params)
                    self.graph = graph
                    tracing.count("serve.graph_captures", 1)
            current.wait_stream(stream)
            if not self.warm:
                self.warm = True
                return logits
        self.graph.replay()
        tracing.count("serve.graph_replays", 1)
        return self.logits


def lookup(cfg: ArchConfig, params, prompts: torch.Tensor,
           max_new_tokens: int, make_caches: Callable[[], List[Any]]
           ) -> Optional[DecodeGraph]:
    """The graph of this call's key, a new one (its static caches from
    ``make_caches()``) where the call decodes two tokens or more, or
    ``None``: on the CPU, and where a single step could only warm up."""
    if prompts.device.type != "cuda":
        return None
    b, t = prompts.shape
    key = _key(cfg, params, b, t + max_new_tokens, prompts.device)
    found = _store.get(key)
    if found is not None:
        _store.move_to_end(key)
        return found
    if max_new_tokens < 2:
        return None
    _store[key] = found = DecodeGraph(cfg, make_caches(), b, prompts.device)
    while len(_store) > MAX_GRAPHS:
        _store.popitem(last=False)
    return found
