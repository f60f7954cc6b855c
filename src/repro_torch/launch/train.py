"""Training launcher of the port: a thin client of ``build_runtime``.

``--config runtime.json`` builds the runtime from a checked-in
:class:`RuntimeConfig` (``examples/runtime_configs/{local,zero}.json``);
otherwise the flags below map onto one (``--dump-config`` prints it).  The
run goes to the first CUDA device unless ``--device cpu`` is given.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --config examples/runtime_configs/zero.json --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --runtime zero --strategy lbl --steps 10 --device cpu
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHITECTURES
from repro_torch.runtime import (ExecutionConfig, MeasureConfig,
                                 NetworkConfig, RuntimeConfig,
                                 ScheduleConfig, build_runtime)


def config_from_flags(args) -> RuntimeConfig:
    """The argparse → RuntimeConfig mapping of the ported runtimes."""
    network = None
    if args.runtime == "zero":
        network = NetworkConfig(bandwidth_gbps=args.bw_gbps)
    return RuntimeConfig(
        runtime=args.runtime, arch=args.arch, reduced=args.reduced,
        batch=args.batch, seq=args.seq, optimizer=args.optimizer, lr=args.lr,
        schedule=ScheduleConfig(strategy=args.strategy, network=network),
        execution=ExecutionConfig(zero3=args.zero3),
        measure=MeasureConfig(compute_flops_per_s=args.worker_flops))


def main(argv=None):
    """Run the launcher; returns the losses of the steps it ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="build the runtime from this RuntimeConfig JSON "
                         "file instead of the flags below")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the RuntimeConfig JSON for these flags "
                         "and exit")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the first CUDA device (default) or on "
                         "the host with the plain PyTorch kernels")
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES),
                    default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--runtime", choices=("local", "zero"), default="local")
    ap.add_argument("--strategy", default="dynacomm",
                    choices=("sequential", "lbl", "ibatch", "dynacomm"))
    ap.add_argument("--bw-gbps", type=float, default=10.0,
                    help="edge uplink bandwidth (Gbit/s) the plan prices")
    ap.add_argument("--worker-flops", type=float, default=1e10,
                    help="edge-worker compute rate fed to the profiler")
    ap.add_argument("--zero3", action="store_true",
                    help="zero: re-pull middle-layer weights for the "
                         "backward instead of keeping them")
    ap.add_argument("--steps", type=int, default=100,
                    help="training steps to run (must be >= 1)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", choices=("adamw", "sgd"), default="adamw")
    ap.add_argument("--checkpoint", default=None,
                    help="save the runtime state here every "
                         "--checkpoint-every steps and after training")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    config = (RuntimeConfig.load(args.config) if args.config is not None
              else config_from_flags(args))
    if args.dump_config:
        print(config.to_json())
        return None
    if args.steps < 1:
        raise SystemExit(f"--steps must be >= 1, got {args.steps}")

    rt = build_runtime(config, device=args.device)
    print(f"[{config.runtime}] arch {config.arch}"
          + (" (reduced)" if config.reduced else "")
          + f", strategy {config.schedule.strategy}, device {rt.device}")
    if config.runtime == "zero":
        plan = rt.plan
        print(f"[zero] {rt.trainer.axis_size} ranks; "
              f"{len(plan.forward)} pull / {len(plan.backward)} push buckets")

    t0 = time.perf_counter()
    losses = []
    while len(losses) < args.steps:
        chunk = min(args.log_every or args.steps, args.steps - len(losses))
        losses.extend(rt.fit(
            chunk,
            checkpoint_every=(args.checkpoint_every if args.checkpoint
                              else 0),
            checkpoint_path=args.checkpoint))
        if args.log_every:
            dt = (time.perf_counter() - t0) / max(len(losses), 1)
            print(f"step {len(losses):4d}  loss {losses[-1]:.4f}  "
                  f"{dt:.3f}s/step")

    led = rt.ledger
    print(f"[{config.runtime}] {len(losses)} steps, final loss "
          f"{losses[-1]:.4f}; transfers: "
          f"{led['pull_bytes'] / 1e6:.1f} MB down / "
          f"{led['push_bytes'] / 1e6:.1f} MB up "
          f"({led['num_pulls']} pulls, {led['num_pushes']} pushes)")
    if args.checkpoint:
        rt.save_state(args.checkpoint)
        print(f"saved runtime state to {args.checkpoint}")
    return losses


if __name__ == "__main__":
    main()
