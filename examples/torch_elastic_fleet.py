"""Elastic-fleet demo on the PyTorch port: membership churn on the
deterministic event engine.

Two acts:

1. **the registered runtime** — a ``fleet-async`` ``RuntimeConfig`` with
   a scripted membership schedule (a worker joins, another crashes
   mid-push) on the reduced text arch.  Each membership event re-plans
   every surviving worker through the topology scheduler, and with
   ``workers_per_shard`` the server re-shards in place, migrating
   versioned state (parameters + optimizer moments) without losing a
   byte.  ``fit(checkpoint_every=...)`` writes periodic checkpoints (the
   port's ``save_state`` format) that include the live event loop, so the
   resumed run replays the remaining pushes bit-identically.
2. **silent failures** — the library API on the smoke CNN: a worker
   stalls (it just stops committing — nothing is announced) and the
   stall detector evicts it after ``stall_factor`` times its believed
   iteration time; another worker silently slows down and the measured
   drift detector re-plans from its observed commit gaps.

The run goes to the first CUDA device unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_elastic_fleet.py
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.fleet import (FleetEvent, FleetSchedule, FleetTrainer,
                               WorkerSpec)
from repro_torch.models.cnn import small_cnn_init, small_cnn_loss
from repro_torch.optim import sgd
from repro_torch.runtime import (ExecutionConfig, FleetConfig,
                                 FleetEventConfig, RuntimeConfig,
                                 ScheduleConfig, TopologyConfig,
                                 build_runtime)
from repro_torch.runtime.registry import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--pushes", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args()
    device = resolve_device(None if args.device == "cuda" else args.device)

    # --- 1. the fleet-async runtime with scripted churn ----------------
    config = RuntimeConfig(
        runtime="fleet-async", arch=args.arch, reduced=True,
        batch=args.batch, seq=args.seq, optimizer="adamw", lr=1e-3,
        schedule=ScheduleConfig(topology=TopologyConfig(
            servers=2, workers=args.workers)),
        execution=ExecutionConfig(staleness=2, throttle="wait"),
        fleet=FleetConfig(events=(
            FleetEventConfig(time=0.01, kind="join", worker=args.workers,
                             down_gbps=5.0, up_gbps=0.5),
            FleetEventConfig(time=0.03, kind="fail", worker=1,
                             mode="crash"),
        ), workers_per_shard=2))
    rt = build_runtime(config, device=device)

    print(f"fleet-async on {config.arch} (reduced), "
          f"{args.workers} workers + scripted join/crash:")
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "fleet.npz")
        half = args.pushes // 2
        losses = rt.fit(half, checkpoint_every=half, checkpoint_path=ck)
        rest = rt.fit(args.pushes - half)

        # a second adapter restored from the periodic checkpoint replays
        # the remaining pushes bit-identically (loop state included)
        rt2 = build_runtime(config, device=device)
        rt2.restore_state(ck)
        rest2 = rt2.fit(args.pushes - half)
        print(f"  {len(losses + rest)} pushes, final loss "
              f"{rest[-1]:.4f}; resumed-from-checkpoint tail "
              f"{'bit-identical' if rest == rest2 else 'DIVERGED'}")

    for e in rt.events:
        if hasattr(e, "resharded"):
            extra = (f", resharded to {e.num_servers} shards "
                     f"({e.migrated_bytes / 1e6:.2f} MB migrated)"
                     if e.resharded else "")
            print(f"  t={e.sim_time:.3f} re-plan ({e.reason}): "
                  f"{e.num_workers} workers{extra}")

    # --- 2. silent failures: stall eviction + measured drift -----------
    params = small_cnn_init(torch.Generator(device=device).manual_seed(0))

    def loss_fn(layers, batch):
        return small_cnn_loss({"layers": layers}, batch["images"],
                              batch["labels"])

    def batch_fn(w, i):
        r = np.random.default_rng(100003 * w + i)
        return {"images": torch.as_tensor(r.normal(size=(2, 32, 32, 3)),
                                          dtype=torch.float32,
                                          device=device),
                "labels": torch.as_tensor(r.integers(0, 10, size=(2,)),
                                          dtype=torch.int64, device=device)}

    # compute-heavy specs so a drifted compute rate moves the commit gap;
    # the drift (2.5x) stays under the stall factor (4x), so the slowed
    # worker keeps committing and the DRIFT detector — not the stall
    # check — is what reacts
    specs = {w: WorkerSpec(down_bps=100e9, up_bps=100e9, flops=1e8)
             for w in range(4)}
    schedule = FleetSchedule((
        FleetEvent(time=0.5, kind="drift", worker=0, factor=2.5),
        FleetEvent(time=1.0, kind="fail", worker=3, mode="stall"),
    ))
    tr = FleetTrainer(
        init_layers=params["layers"], loss_fn=loss_fn,
        optimizer=sgd(0.05, 0.9), workers=specs, schedule=schedule,
        num_servers=2, staleness=2, throttle="wait", stall_factor=4.0)
    log = tr.run(60, batch_fn)

    print("\nsmoke CNN, 4 workers: worker 0 silently drifts 2.5x slower "
          "at t=0.5, worker 3 silently stalls at t=1.0:")
    for e in tr.membership_events:
        print(f"  t={e.sim_time:.3f} {e.kind} worker {e.worker} "
              f"(fleet size {e.fleet_size})")
    drift_replans = [e for e in tr.replan_events if e.reason == "drift"]
    stall_evicts = [e for e in tr.membership_events
                    if e.kind == "stall-evict"]
    print(f"  {len(log.accepted)} pushes, max staleness "
          f"{log.max_staleness} <= k=2; drift re-plans: "
          f"{len(drift_replans)}, stall evictions: {len(stall_evicts)}")
    print("  -> nothing was scripted for the planner: the drift was "
          "*measured* from commit gaps, the stall was *detected* by the "
          "overdue-commit check")


if __name__ == "__main__":
    main()
