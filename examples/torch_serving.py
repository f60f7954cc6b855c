"""Serve a small model with batched requests on the PyTorch port: prefill
+ KV-cache decode.

Parameters come from a generator on the device seeded 0, prompts from
``numpy.random.default_rng(1)`` and the sampled tokens from a generator
seeded 2, as ``repro_torch.launch.serve`` draws them.  The run goes to
the first CUDA device unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_serving.py --arch gemma2-2b --tokens 32
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import seeded_inputs
from repro_torch.runtime.registry import resolve_device
from repro_torch.serve.decode import batched_generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args()
    device = resolve_device(None if args.device == "cuda" else args.device)

    cfg = get_config(args.arch).reduced()
    params, prompts, sampler = seeded_inputs(
        cfg, device, args.batch, args.prompt_len, greedy=False)

    t0 = time.perf_counter()
    out = batched_generate(cfg, params, prompts,
                           max_new_tokens=args.tokens,
                           greedy=False, generator=sampler)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    print(f"arch {cfg.name}: generated {total} tokens "
          f"({args.batch} requests x {args.tokens}) in {dt:.2f}s "
          f"= {total / dt:.1f} tok/s")
    print("sample continuation token ids:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
