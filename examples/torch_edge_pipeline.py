"""Pipeline-parallel edge training demo on the PyTorch port:
DynaComm-scheduled activations.

A reduced transformer is split into ``--stages`` balanced stages (min-max
DP over profiled fc + bc), micro-batched ``--microbatches`` ways under a
GPipe or 1F1B schedule, and trained with every inter-stage activation /
activation-gradient transfer planned by the *same* DP that schedules the
paper's push/pull traffic — chunks of the boundary tensor play the role
of layers, the receiving stage's compute plays the role of layer compute,
and ``dp_forward``/``dp_backward`` decide which chunks batch into one
message (amortizing Δt) versus segment to overlap with stage compute.

The run prints the stage partition, the per-boundary transfer plans
(segmented vs whole-tensor makespan), the simulated 1F1B timeline with
its bubble fraction, and the boundary-byte ledger.  One process holds
every stage, on the first CUDA device unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_edge_pipeline.py --steps 10
"""

import argparse

from repro_torch.runtime import (MeasureConfig, NetworkConfig,
                                 PipelineConfig, RuntimeConfig,
                                 ScheduleConfig, build_runtime)
from repro_torch.runtime.registry import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--schedule", default="1f1b", choices=("gpipe", "1f1b"))
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--bw-gbps", type=float, default=0.1,
                    help="edge uplink (default: the paper's 100 Mbps)")
    ap.add_argument("--worker-flops", type=float, default=1e10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args()
    device = resolve_device(None if args.device == "cuda" else args.device)

    config = RuntimeConfig(
        runtime="pipeline", arch=args.arch, batch=args.batch, seq=args.seq,
        pipeline=PipelineConfig(stages=args.stages,
                                microbatches=args.microbatches,
                                schedule=args.schedule, chunks=args.chunks),
        schedule=ScheduleConfig(
            network=NetworkConfig(bandwidth_gbps=args.bw_gbps)),
        measure=MeasureConfig(compute_flops_per_s=args.worker_flops))
    rt = build_runtime(config, device=device)
    tr = rt.trainer

    part = rt.partition
    print(f"arch: {args.arch} (reduced)  stages: {args.stages}  "
          f"micro-batches: {args.microbatches}  schedule: {args.schedule}")
    print(f"partition (by profiled fc+bc): "
          f"{[list(s) for s in part.segments]}  "
          f"loads: {[round(l, 4) for l in part.loads]}")

    losses = rt.fit(args.steps)
    print(f"\ntrained {len(losses)} steps: first loss {losses[0]:.4f}  "
          f"last loss {losses[-1]:.4f}")

    plans = tr.transfer_plans()
    if plans:
        print(f"\nboundary transfer plans at {args.bw_gbps:g} Gbps "
              f"(chunks={args.chunks}):")
        for p in plans:
            print(f"  boundary {p.boundary}: "
                  f"{len(p.decision[0])} fwd / {len(p.decision[1])} bwd "
                  f"segments  "
                  f"segmented {p.fwd_time + p.bwd_time:.4f}s vs "
                  f"whole {p.whole_fwd_time + p.whole_bwd_time:.4f}s  "
                  f"speedup {p.speedup:.3f}x")

    tl = tr.timeline()
    if tl is not None:
        print(f"\nsimulated {args.schedule} timeline: "
              f"makespan {tl.makespan * 1e3:.2f} ms  "
              f"bubble {tl.bubble_fraction:.3f}")

    led = rt.ledger
    print(f"\nledger: {led['num_pulls']} pulls "
          f"({led['pull_bytes'] / 1e6:.2f} MB activations) / "
          f"{led['num_pushes']} pushes "
          f"({led['push_bytes'] / 1e6:.2f} MB activation grads)")
    stats = tr.planner.stats if tr.planner is not None else None
    if stats is not None:
        print(f"planner: {stats.solves} solves, {stats.hits} hits "
              f"(homogeneous boundaries collapse to cache hits)")


if __name__ == "__main__":
    main()
