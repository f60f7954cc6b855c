"""Serving launcher of the port: prefill + batched decode for ``--arch <id>``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --requests 4 --prompt-len 32 --tokens 32 --device cpu

The run goes to the first CUDA device unless ``--device cpu`` is given (and
raises without a card).  Parameters come from a ``torch.Generator`` on the
device seeded 0, as the train launcher's; prompts from
``numpy.random.default_rng(1)`` (the reference's ``jax.random.randint``
cannot be replayed); sampling (without ``--greedy``) from a generator
seeded 2.  It prints the prefill's ms, the decode's ms a token (all, and
steady: the mean after the first token), tokens/s as the reference counts
them (requests x tokens over the whole ``batched_generate``, prefill
included), the cache bytes after the prefill and, on the card, the peak
memory.  Times on the card come from CUDA events recorded after the
prefill and each decode step, so the loop is never synchronised.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models import init_params, tree_bytes
from repro_torch.runtime.registry import resolve_device
from repro_torch.serve.decode import StepHook, batched_generate


class _Marks:
    """A time mark after the prefill and after each decode step: CUDA
    events on the card (read after the run), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Any] = []
        self.start = self._mark()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def add(self) -> None:
        self.marks.append(self._mark())

    def ms(self) -> List[float]:
        """Each mark's ms since the start (after a synchronize)."""
        if self.cuda:
            return [self.start.elapsed_time(m) for m in self.marks]
        return [(m - self.start) * 1e3 for m in self.marks]


def seeded_inputs(cfg, device: torch.device, requests: int,
                  prompt_len: int, greedy: bool) -> tuple:
    """(parameters, prompts, sampler) of a served run: parameters from a
    generator on ``device`` seeded 0, int32 prompts from
    ``numpy.random.default_rng(1)``, and a generator seeded 2 for the
    Gumbel-max draw (``None`` when ``greedy``)."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (requests, prompt_len),
        dtype=np.int32)).to(device)
    sampler = None if greedy else \
        torch.Generator(device=device).manual_seed(2)
    return params, prompts, sampler


def main(argv=None, on_step: Optional[StepHook] = None) -> Dict[str, Any]:
    """Run the launcher; ``on_step`` sees each step's logits and caches
    (``serve.decode.StepHook``).  Returns the run: its config, parameters,
    prompts, tokens and the numbers it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the first CUDA device (default; raises without "
                         "one) or the host with the plain PyTorch path")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    if cfg.frontend != "none":
        raise SystemExit("serve.py drives text archs")
    if args.tokens < 1:
        raise SystemExit(f"--tokens must be >= 1, got {args.tokens}")
    device = resolve_device(None if args.device == "cuda" else args.device)

    params, prompts, sampler = seeded_inputs(
        cfg, device, args.requests, args.prompt_len, args.greedy)
    seen: Dict[str, int] = {}

    def hook(i, logits, caches):
        marks.add()
        if i == 0:
            seen["cache_bytes"] = tree_bytes(caches)
        if on_step is not None:
            on_step(i, logits, caches)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    marks = _Marks(device)
    out = batched_generate(cfg, params, prompts, max_new_tokens=args.tokens,
                           greedy=args.greedy, generator=sampler,
                           on_step=hook)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    ms = marks.ms()
    steps = np.diff(ms)                         # each decode step's ms
    run = dict(
        cfg=cfg, params=params, prompts=prompts, tokens=out, seconds=dt,
        prefill_ms=ms[0], decode_ms=float(steps.mean()),
        decode_ms_steady=float(steps[1:].mean()) if len(steps) > 1
        else float(steps[0]),
        tokens_per_s=args.requests * args.tokens / dt,
        cache_bytes=seen["cache_bytes"],
        peak_bytes=torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else None)
    n = args.requests * args.tokens
    print(f"{cfg.name}: {n} tokens in {dt:.2f}s = {n / dt:.1f} tok/s "
          f"(device {device})")
    print(f"prefill {run['prefill_ms']:.1f} ms ({args.requests} x "
          f"{args.prompt_len}); decode {run['decode_ms']:.2f} ms a token, "
          f"{run['decode_ms_steady']:.2f} steady; caches "
          f"{run['cache_bytes']:,} B" + (
              "" if run["peak_bytes"] is None else
              f"; peak {run['peak_bytes'] / 2**30:.2f} GiB"))
    print("first request continuation:", out[0].tolist())
    return run


if __name__ == "__main__":
    main()
