"""Bandwidth-drift demo on the PyTorch port: watch the schedule re-segment
mid-training.

The run-time loop of the paper (Section IV-C), end to end: a ~100M-param
model trains under the DynaComm-bucketed ZeRO trainer while the edge
uplink degrades from 10 Gbps to 1 Gbps at ``--shift-epoch``.  On the epoch
boundary the profiler re-derives pt/gt/Δt from the new network condition,
the DP re-plans, and the dynamic runtime swaps in the step for the new
bucket plan (cached by plan, so a later recovery to 10 Gbps swaps back
without rebuilding).  The whole regime — drifting network included — is
one ``RuntimeConfig`` literal built through ``build_runtime``; the ASCII
timelines show *why* the decision moves: cheaper transmission favours
more, smaller segments overlapped with compute; an expensive link
amortizes Δt over fewer, larger ones.  ``coll`` counts the all-gathers
and reduce-scatters each plan's first step launched.  The run goes to
the first CUDA device unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_bandwidth_drift.py --steps 60
"""

import argparse
import dataclasses

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.viz import render_timeline
from repro_torch.dist.zero import default_group
from repro_torch.runtime import (MeasureConfig, NetworkConfig, RuntimeConfig,
                                 ScheduleConfig, build_runtime)
from repro_torch.runtime.registry import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--steps-per-epoch", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--bw-gbps", type=float, default=10.0)
    ap.add_argument("--shift-gbps", type=float, default=1.0)
    ap.add_argument("--shift-epoch", type=int, default=1)
    ap.add_argument("--worker-flops", type=float, default=1e10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args()
    device = resolve_device(None if args.device == "cuda" else args.device)

    cfg = dataclasses.replace(
        get_config(args.arch).reduced(num_layers=args.layers,
                                      d_model=args.d_model, vocab=8192),
        name=f"{args.arch}-drift-demo")
    n_dev = dist.get_world_size(default_group(device))
    print(f"devices: {n_dev}  arch: {cfg.name}  layers: {cfg.num_layers}  "
          f"uplink: {args.bw_gbps:g} Gbps → {args.shift_gbps:g} Gbps at "
          f"epoch {args.shift_epoch}")

    config = RuntimeConfig(
        runtime="dynamic", arch=cfg.name, batch=args.batch, seq=args.seq,
        schedule=ScheduleConfig(
            reschedule_every=args.steps_per_epoch,
            network=NetworkConfig(bandwidth_gbps=args.bw_gbps,
                                  shift_gbps=args.shift_gbps,
                                  shift_epoch=args.shift_epoch)),
        measure=MeasureConfig(compute_flops_per_s=args.worker_flops))
    rt = build_runtime(config, model=cfg, device=device)

    done = 0
    while done < args.steps:
        losses = rt.fit(min(10, args.steps - done))
        done += len(losses)
        print(f"step {done:4d}  epoch {rt.trainer.epoch}  "
              f"loss {losses[-1]:.4f}  buckets "
              f"{len(rt.plan.forward)}/{len(rt.plan.backward)}")

    dyn, net = rt.trainer, rt.trainer.network
    print("\nre-scheduling history:")
    shown = set()
    for e in rt.events:
        ag, rs = dyn.collective_counts(e.plan)
        print(f"  epoch {e.epoch:3d}: {len(e.plan.forward)} pull / "
              f"{len(e.plan.backward)} push buckets (coll {ag} ag / {rs} rs)"
              f"  {'RE-SEGMENTED' if e.plan_changed else 'unchanged'}"
              f"{' via step cache' if e.plan_changed and not e.retraced else ''}"
              f"  sched {e.scheduling_seconds * 1e3:.2f} ms "
              f"hidden={e.overhead_hidden}")
        if e.plan not in shown:
            shown.add(e.plan)
            costs = dyn.costs_for_epoch(e.epoch, None, None)
            # forward buckets back to the paper's 1-indexed segments
            segments = tuple((b[0] + 1, b[-1] + 1) for b in e.plan.forward)
            bw = net.model_at(e.epoch).bandwidth_bps / 1e9
            print(f"  --- forward timeline at {bw:g} Gbps ---")
            for line in render_timeline(costs, segments,
                                        phase="forward").splitlines():
                print(f"  {line}")

    changed = any(e.plan_changed for e in rt.events)
    print(f"\nplans traced: {dyn.traces}  cache hits: {dyn.cache_hits}")
    print("schedule re-segmented under drift" if changed
          else "WARNING: decision did not change — try --worker-flops 1e9")


if __name__ == "__main__":
    main()
