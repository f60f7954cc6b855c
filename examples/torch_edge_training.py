"""End-to-end run on the PyTorch port: train a ~100M-parameter model
with the DynaComm bucketed ZeRO trainer for a few hundred steps.

The whole pipeline — profile → DP decision → bucket plan → bucketed
trainer — is one config literal: the example builds a ``RuntimeConfig``,
hands the (custom, ~100M-param) arch to ``build_runtime``, and drives the
returned ``Trainer`` protocol object.  Swap ``runtime="zero"`` for any
other registered name to run the same model under a different regime.
The run goes to the first CUDA device (and raises without one) unless
``--device cpu`` is given; ``devices`` is the world size of the process
group, 1 in one process.

    PYTHONPATH=src python examples/torch_edge_training.py --steps 200
    PYTHONPATH=src python examples/torch_edge_training.py --steps 20 \
        --device cpu
"""

import argparse
import dataclasses
import time

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.dist.zero import default_group
from repro_torch.runtime import (MeasureConfig, NetworkConfig, RuntimeConfig,
                                 ScheduleConfig, build_runtime)
from repro_torch.runtime.registry import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--strategy", default="dynacomm")
    ap.add_argument("--bw-gbps", type=float, default=1.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args()
    device = resolve_device(None if args.device == "cuda" else args.device)

    # ~100M-param reduced variant of the chosen architecture
    cfg = dataclasses.replace(
        get_config(args.arch).reduced(num_layers=args.layers,
                                      d_model=args.d_model, vocab=8192),
        name=f"{args.arch}-demo")
    n_dev = dist.get_world_size(default_group(device))
    print(f"devices: {n_dev}  arch: {cfg.name}  layers: {cfg.num_layers}  "
          f"d_model: {cfg.d_model}")

    # the whole regime is one config literal; the custom arch rides along
    config = RuntimeConfig(
        runtime="zero", arch=cfg.name, batch=args.batch, seq=args.seq,
        schedule=ScheduleConfig(
            strategy=args.strategy,
            network=NetworkConfig(bandwidth_gbps=args.bw_gbps)),
        measure=MeasureConfig(compute_flops_per_s=1e12))
    rt = build_runtime(config, model=cfg, device=device)
    plan = rt.plan
    print(f"strategy {args.strategy}: {len(plan.forward)} pull buckets, "
          f"{len(plan.backward)} push buckets (scheduling took "
          f"{rt.scheduler.last_scheduling_seconds * 1e3:.2f} ms)")

    t0 = time.perf_counter()
    losses = rt.fit(args.steps, log_every=20)
    dt = (time.perf_counter() - t0) / max(len(losses), 1)
    led = rt.ledger
    print(f"{len(losses)} steps at {dt:.3f}s/step; moved "
          f"{led['pull_bytes'] / 1e9:.2f} GB down / "
          f"{led['push_bytes'] / 1e9:.2f} GB up")
    print("done.")


if __name__ == "__main__":
    main()
