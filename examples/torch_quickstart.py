"""Quickstart of the PyTorch port: schedule a model's communications with
DynaComm.

Profiles a reduced granite-3-2b analytically, runs every strategy, prints
the decisions and the predicted iteration times, and shows the timeline
breakdown — the paper's core loop in ~40 lines.  Everything here is host
arithmetic: no tensor is placed, so ``--device`` has nothing to place and
is accepted only so that every example takes it.

    PYTHONPATH=src python examples/torch_quickstart.py
"""

import argparse

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import (EdgeNetworkModel, costs_from_profiles,
                              evaluate, schedule, simulate_iteration)
from repro_torch.models.profiles import layer_profiles


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="accepted for symmetry; nothing is placed")
    ap.parse_args()

    cfg = get_config("granite-3-2b")
    shape = INPUT_SHAPES["train_4k"]

    # analytic per-layer profile → cost vectors under an edge network
    profiles = layer_profiles(cfg, shape, param_dtype=torch.float32)
    costs = costs_from_profiles(
        profiles,
        net=EdgeNetworkModel(bandwidth_bps=2e9),    # 2 Gbps edge uplink
        compute_flops_per_s=5e12,                   # edge accelerator
    )
    print(f"model: {cfg.name}  sched-layers: {costs.num_layers}  "
          f"Δt: {costs.dt * 1e3:.1f} ms")

    for strategy in ("sequential", "lbl", "ibatch", "dynacomm"):
        decision = schedule(costs, strategy)
        times = evaluate(costs, decision)
        fwd, bwd = decision
        print(f"{strategy:10s}  fwd buckets {len(fwd):3d}  "
              f"bwd buckets {len(bwd):3d}  iteration {times['total']:.3f}s")

    # timeline breakdown for the optimal schedule (paper Figs. 5-8 bars)
    fwd, bwd = schedule(costs, "dynacomm")
    tl = simulate_iteration(costs, fwd, bwd)
    for phase in ("forward", "backward"):
        br = tl.breakdown(phase)
        print(f"{phase:8s}: compute-only {br.comp_only:.3f}s  "
              f"overlap {br.overlap:.3f}s  comm-only {br.comm_only:.3f}s")

    # and the Gantt view (paper Fig. 2/3)
    from repro_torch.core.viz import render_timeline
    for strategy in ("sequential", "dynacomm"):
        f, _ = schedule(costs, strategy)
        print(f"\n[{strategy}]")
        print(render_timeline(costs, f, phase="forward"))


if __name__ == "__main__":
    main()
