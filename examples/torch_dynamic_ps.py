"""Dynamic parameter-server demo on the PyTorch port: re-planning over a
drifting topology, SSP wait-at-barrier vs stale-push rejection, and BSP
push aggregation.

Three acts:

1. **run-time re-planning** — every worker's uplink degrades mid-training
   (``--up-factor``× slower at ``--shift-epoch``).  The ``dynamic-ps``
   runtime — one ``RuntimeConfig`` literal through ``build_runtime`` —
   re-projects the topology's costs on each epoch boundary, re-runs the
   straggler-minimizing consensus decision, and swaps the pull/push step
   from its plan-keyed cache (``coll``: the all-gathers and
   reduce-scatters each plan's first step launched);
2. **SSP throttling** — a 4x-slower edge worker at staleness k=1: the
   `reject` throttle starves it (every push arrives > k versions stale
   and is evicted), the `wait` throttle blocks the fast workers at the
   barrier instead, so the slow worker contributes every cycle and the
   staleness bound still holds;
3. **BSP aggregation** — `wait` + `aggregate` at k=0: same-version
   pushes commit as ONE mean-gradient optimizer step, so the round is
   true bulk-synchronous data parallelism (one version bump per round of
   W pushes) instead of W serialized commits.

The run goes to the first CUDA device unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_dynamic_ps.py
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.zero import default_group
from repro_torch.models.cnn import small_cnn_init, small_cnn_loss
from repro_torch.optim import sgd
from repro_torch.ps import AsyncPSTrainer, PSTopology, asymmetric_link
from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                 TopologyConfig, build_runtime)
from repro_torch.runtime.registry import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--steps-per-epoch", type=int, default=4)
    ap.add_argument("--shift-epoch", type=int, default=1)
    ap.add_argument("--up-factor", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--staleness", type=int, default=1)
    ap.add_argument("--async-pushes", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args()
    device = resolve_device(None if args.device == "cuda" else args.device)

    # --- 1. re-planning across an uplink degradation -------------------
    n_dev = dist.get_world_size(default_group(device))
    config = RuntimeConfig(
        runtime="dynamic-ps", arch=args.arch, batch=args.batch,
        seq=args.seq, optimizer="adamw", lr=1e-3,
        schedule=ScheduleConfig(
            reschedule_every=args.steps_per_epoch,
            topology=TopologyConfig(
                servers=args.servers, down_gbps=10.0, up_gbps=10.0,
                worker_flops=1e10, up_shift_factor=args.up_factor,
                shift_epoch=args.shift_epoch)))
    print(f"topology: {args.servers} shards x {n_dev} workers; every "
          f"uplink {args.up_factor:g}x slower from epoch "
          f"{args.shift_epoch}")
    rt = build_runtime(config, device=device)
    done = 0
    while done < args.steps:
        losses = rt.fit(min(4, args.steps - done))
        done += len(losses)
        print(f"  step {done:4d}  epoch {rt.trainer.epoch}  "
              f"loss {losses[-1]:.4f}")
    for e in rt.events:
        ag, rs = rt.trainer.collective_counts(e.plan)
        print(f"  epoch {e.epoch}: {len(e.plan.forward)} pull / "
              f"{len(e.plan.backward)} push segments (coll {ag} ag/{rs} rs)"
              f" {'re-segmented' if e.plan_changed else 'unchanged'}, "
              f"sched {e.scheduling_seconds * 1e3:.2f} ms, "
              f"hidden={e.overhead_hidden}")
    print(f"  traces {rt.trainer.traces} (one per distinct plan), cache "
          f"hits {rt.trainer.cache_hits}\n")

    # --- 2+3. throttles on the smoke CNN (library API: the factory is
    # arch-scoped; the CNN demos drive AsyncPSTrainer directly) ---------
    from repro_torch.core import plan_from_decision
    params = small_cnn_init(torch.Generator(device=device).manual_seed(0))
    L = len(params["layers"])
    cnn_plan = plan_from_decision(((1, 3), (4, L)), ((4, L), (1, 3)), L)
    topo = PSTopology(
        num_servers=args.servers,
        links=tuple(asymmetric_link(10e9, 1e9) for _ in range(4)),
        worker_flops=(4e10, 4e10, 4e10, 1e10))       # worker 3: 4x slower

    def loss_fn(layers, batch):
        return small_cnn_loss({"layers": layers}, batch["images"],
                              batch["labels"])

    def batch_fn(w, i):
        r = np.random.default_rng(100003 * w + i)
        return {"images": torch.as_tensor(
                    r.normal(size=(args.batch, 32, 32, 3)),
                    dtype=torch.float32, device=device),
                "labels": torch.as_tensor(
                    r.integers(0, 10, size=(args.batch,)),
                    dtype=torch.int64, device=device)}

    print(f"async smoke CNN, 4 workers (worker 3 is 4x slower), "
          f"k={args.staleness}:")
    for throttle in ("reject", "wait"):
        tr = AsyncPSTrainer(init_layers=params["layers"], loss_fn=loss_fn,
                            optimizer=sgd(0.05, 0.9), topology=topo,
                            plan=cnn_plan, staleness=args.staleness,
                            throttle=throttle)
        log = tr.run(args.async_pushes, batch_fn)
        by_worker = {w: log.accepted_by_worker().get(w, 0)
                     for w in range(topo.num_workers)}
        print(f"  {throttle:6s}: accepted per worker {by_worker}, "
              f"{log.num_rejected} rejected, "
              f"{log.total_wait_s:.2f}s waited at the barrier, "
              f"max staleness {log.max_staleness} <= k")
    print("  -> `wait` blocks fast workers at the SSP barrier instead of "
          "evicting the slow worker's pushes: everyone contributes and "
          "the bound still holds")

    print("\nBSP aggregation (wait + aggregate, k=0): same-version pushes "
          "commit as one mean-gradient step")
    tr = AsyncPSTrainer(init_layers=params["layers"], loss_fn=loss_fn,
                        optimizer=sgd(0.05, 0.9), topology=topo,
                        plan=cnn_plan, staleness=0, throttle="wait",
                        aggregate=True)
    log = tr.run(args.async_pushes, batch_fn)
    heads = [e.result.version for e in log.events]
    rounds = len(set(heads))
    by_worker = {w: log.accepted_by_worker().get(w, 0)
                 for w in range(topo.num_workers)}
    print(f"  {len(log.accepted)} pushes in {rounds} BSP rounds "
          f"(one version bump per round of {topo.num_workers}), accepted "
          f"per worker {by_worker}, max staleness {log.max_staleness}")


if __name__ == "__main__":
    main()
