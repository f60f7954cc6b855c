"""The paper's CNN case study on the PyTorch port, from the command line.

Prints the per-strategy normalized execution times for any of the paper's
four models under the calibrated edge testbed, plus the chosen decisions.
The testbed (``edge_network``, ``cnn_costs`` and their constants) is kept
here, over ``repro_torch.core`` and ``repro_torch.models.cnn``.  It is
host arithmetic only: ``--device`` has nothing to place.

    PYTHONPATH=src python examples/torch_paper_cnn_study.py --model resnet152
"""

import argparse

from repro_torch.core import (EdgeNetworkModel, LayerCosts,
                              costs_from_profiles, evaluate, schedule)
from repro_torch.models.cnn import PAPER_CNNS

# Calibrated to the paper's Section V setup: 8 edge workers (4-core Xeon
# E3-1220 ≈ 1e11 FLOP/s effective on conv nets), 4 parameter servers on a
# 10 Gbps cloud uplink (≈1.25 Gbps effective per worker with 8 workers).
WORKER_FLOPS = 1.0e11           # effective conv FLOP/s per edge worker
SERVER_BW_BPS = 10e9            # nominal cloud-side fabric
NET_EFFICIENCY = 0.4            # TCP/VM goodput factor on the 10 Gbps fabric
BWD_FWD_RATIO = 1.2             # measured MXNet conv bwd/fwd time ratio
DEFAULT_WORKERS = 8


def edge_network(workers: int = DEFAULT_WORKERS,
                 server_bw_bps: float = SERVER_BW_BPS) -> EdgeNetworkModel:
    per_worker = server_bw_bps * NET_EFFICIENCY / max(workers, 1)
    return EdgeNetworkModel(bandwidth_bps=per_worker)


def cnn_costs(model: str, *, batch: int = 32,
              workers: int = DEFAULT_WORKERS) -> LayerCosts:
    from repro_torch.core.profiler import LayerProfile
    profiles = [
        LayerProfile(name=p.name, param_bytes=p.param_bytes,
                     flops_fwd=p.flops_fwd,
                     flops_bwd=BWD_FWD_RATIO * p.flops_fwd)
        for p in PAPER_CNNS[model](batch=batch)
    ]
    return costs_from_profiles(profiles, net=edge_network(workers),
                               compute_flops_per_s=WORKER_FLOPS)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet152",
                    choices=["vgg19", "googlenet", "inception-v4",
                             "resnet152"])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="accepted for symmetry; nothing is placed")
    args = ap.parse_args()

    costs = cnn_costs(args.model, batch=args.batch)
    print(f"{args.model} (batch {args.batch}): L={costs.num_layers}, "
          f"Δt={costs.dt * 1e3:.1f} ms")
    seq = None
    for strategy in ("sequential", "lbl", "ibatch", "dynacomm"):
        decision = schedule(costs, strategy)
        t = evaluate(costs, decision)
        seq = seq or t["total"]
        fwd, bwd = decision
        print(f"  {strategy:10s} iter {t['total']:7.3f}s "
              f"(normalized {t['total'] / seq:.3f}, "
              f"reduced {100 * (1 - t['total'] / seq):5.2f}%)  "
              f"buckets fwd={len(fwd)} bwd={len(bwd)}")


if __name__ == "__main__":
    main()
