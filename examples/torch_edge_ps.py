"""Edge parameter-server demo on the PyTorch port: the paper's deployment
shape, end to end.

A heterogeneous edge fleet — fast and slow workers behind asymmetric
links (edge uplinks are 5-20x slower than downlinks) — trains against
``--servers`` parameter-server shards:

1. **per-topology scheduling** — DynaComm plans per *worker* (each has
   its own fc/bc and pt/gt/Δt); the per-worker optimal decompositions
   differ, and the sync consensus plan minimizes the straggler makespan;
2. **sync mode** — the ``ps`` runtime, built from one ``RuntimeConfig``
   whose ``TopologyConfig`` carries the per-worker link/compute lists
   (heterogeneity is config data, not wiring code), executes the
   consensus plan with one pull + one push transmission per segment;
   per-worker timelines show who gates the barrier;
3. **async mode** — `AsyncPSTrainer` drops the barrier: bounded
   staleness k lets fast workers run ahead up to k versions, the server
   rejects anything staler, and the smoke CNN still converges.

The workers are the ranks of the process group (1 in one process).  The
run goes to the first CUDA device unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_edge_ps.py
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import (consensus_decision, decision_from_plan,
                              plan_from_decision, schedule_topology)
from repro_torch.core.viz import render_ps_timeline
from repro_torch.dist.zero import default_group
from repro_torch.models.cnn import small_cnn_init, small_cnn_loss
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import sgd
from repro_torch.ps import AsyncPSTrainer
from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                 TopologyConfig, build_runtime)
from repro_torch.runtime.registry import resolve_device


def heterogeneous_fleet(num_workers: int, base_flops: float):
    """Half fast workers on good links, half slow ones on degraded links,
    as per-worker config lists (down Gbps, up Gbps, FLOP/s)."""
    down, up, flops = [], [], []
    for w in range(num_workers):
        slow = w >= num_workers // 2
        down.append(2.5 if slow else 10.0)
        up.append(0.25 if slow else 1.0)
        flops.append(base_flops / 4 if slow else base_flops)
    return tuple(down), tuple(up), tuple(flops)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--worker-flops", type=float, default=1e10)
    ap.add_argument("--staleness", type=int, default=1)
    ap.add_argument("--async-pushes", type=int, default=30)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args()
    device = resolve_device(None if args.device == "cuda" else args.device)

    n_dev = dist.get_world_size(default_group(device))
    down, up, flops = heterogeneous_fleet(n_dev, args.worker_flops)
    config = RuntimeConfig(
        runtime="ps", arch=args.arch, batch=args.batch, seq=args.seq,
        optimizer="adamw", lr=1e-3,
        schedule=ScheduleConfig(topology=TopologyConfig(
            servers=args.servers, down_gbps=down, up_gbps=up,
            worker_flops=flops)))
    print(f"topology: {args.servers} server shards x {n_dev} workers "
          f"(half at 1/4 compute on 1/4 bandwidth)")

    # --- 1. per-worker planning: the decompositions genuinely differ ----
    cfg = get_config(args.arch).reduced()
    shape = InputShape("edge-ps", args.seq, args.batch, "train")
    topo = (config.schedule.topology or TopologyConfig()).build(n_dev)
    costs = topo.topology_costs(layer_profiles(cfg, shape))
    per_worker = schedule_topology(costs, "dynacomm")
    from repro_torch.core import iteration_time
    for w, (f, b) in enumerate(per_worker):
        t = iteration_time(costs.workers[w], f, b)
        print(f"  worker {w}: optimal plan {len(f)} pull / {len(b)} push "
              f"segments, own iter {t:.4f}s")
    decision, makespan = consensus_decision(costs, "dynacomm")
    print(f"  consensus (sync): {len(decision[0])} pull / "
          f"{len(decision[1])} push segments, straggler makespan "
          f"{makespan:.4f}s\n")

    # --- 2. sync mode on the process group, via the runtime factory -----
    rt = build_runtime(config, device=device)
    tr = rt.trainer
    print(render_ps_timeline(costs, decision_from_plan(tr.plan)))
    owners = tr.segment_owners()
    print(f"segment -> shard routing: pulls {owners['forward']}, "
          f"pushes {owners['backward']}")
    rt.fit(args.steps, log_every=10)

    # --- 3. async bounded staleness on the smoke CNN (library API) ------
    print(f"\nasync bounded-staleness (k={args.staleness}) on the smoke "
          f"CNN:")
    params = small_cnn_init(torch.Generator(device=device).manual_seed(0))
    L = len(params["layers"])
    cnn_plan = plan_from_decision(((1, 3), (4, L)), ((4, L), (1, 3)), L)

    def loss_fn(layers, batch):
        return small_cnn_loss({"layers": layers}, batch["images"],
                              batch["labels"])

    atr = AsyncPSTrainer(init_layers=params["layers"], loss_fn=loss_fn,
                         optimizer=sgd(0.05, 0.9), topology=topo,
                         plan=cnn_plan, staleness=args.staleness)

    def batch_fn(w, i):
        r = np.random.default_rng(100003 * w + i)
        return {"images": torch.as_tensor(
                    r.normal(size=(args.batch, 32, 32, 3)),
                    dtype=torch.float32, device=device),
                "labels": torch.as_tensor(
                    r.integers(0, 10, size=(args.batch,)),
                    dtype=torch.int64, device=device)}

    log = atr.run(args.async_pushes, batch_fn)
    print(f"  {len(log.accepted)} accepted / {log.num_rejected} stale-"
          f"rejected pushes; max staleness {log.max_staleness} <= "
          f"k={args.staleness}")
    per_worker_counts = {w: sum(1 for e in log.accepted if e.worker == w)
                         for w in range(topo.num_workers)}
    print(f"  accepted pushes per worker: {per_worker_counts} — no "
          f"barrier: fast workers commit at their own rate, and gradients "
          f"computed more than k versions ago are rejected (raise "
          f"--staleness, or see examples/torch_dynamic_ps.py for the SSP "
          f"wait throttle that lets 4x-slower workers contribute at any k)")
    print(f"  loss {log.losses[0]:.4f} -> {log.losses[-1]:.4f} over "
          f"{len(log.losses)} versions")


if __name__ == "__main__":
    main()
