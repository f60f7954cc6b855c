"""Training launcher of the port: a thin client of ``build_runtime``.

``--config runtime.json`` builds the runtime from a checked-in
:class:`RuntimeConfig` (``examples/runtime_configs/{local,zero,ps,dynamic,
dynamic_ps,ps_async,ps_async_int8,dynamic_ps_async,fleet_async,
pipeline}.json``);
otherwise the flags below map onto one, as the reference's launcher maps
them (``--dump-config`` prints it).  ``--staleness k`` switches ``ps`` /
``dynamic-ps`` to their asynchronous form (``ps-async`` /
``dynamic-ps-async``: the bounded-staleness event loop, ``--throttle
reject|wait``, ``--aggregate`` for BSP rounds, ``--ps-workers`` logical
workers); ``fleet-async`` runs that loop over an elastic fleet
(``--fleet-schedule events.json`` scripts joins, leaves, failures and
drift as a JSON list of fleet event dicts; ``--workers-per-shard`` lets
the shard count track the fleet); ``pipeline`` splits the model into
``--stages`` contiguous stages balanced by profiled fc + bc and runs
``--microbatches`` micro-batches a step under ``--pipeline-schedule``
(gpipe | 1f1b), its boundary transfers planned by DynaComm
(``--transfer-chunks`` splits each micro-batch's boundary tensor).  The
async runtimes' unit of progress is one accepted push.  With
``--config``, ``--compress`` (and ``--topk-fraction`` /
``--no-error-feedback`` with it) replaces the config's compression block,
so one checked-in PS config runs plain, int8 or top-k.  The run goes to the
first CUDA device unless ``--device cpu`` is given.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train \
        --config examples/runtime_configs/zero.json --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train \
        --config examples/runtime_configs/ps.json --compress int8 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --runtime zero --strategy lbl --steps 10 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --runtime dynamic --steps 6 --steps-per-epoch 2 \
        --batch 4 --seq 32 --bw-gbps 10 --bw-shift-gbps 1 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --runtime ps --staleness 1 --throttle wait \
        --ps-workers 2 --steps 6 --batch 2 --seq 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --config examples/runtime_configs/fleet_async.json --steps 6 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --config examples/runtime_configs/pipeline.json --steps 2 \
        --device cpu

The dynamic runtimes re-plan every ``--steps-per-epoch`` steps and print
one line per scheduling pass (``re-segmented`` / ``unchanged``, the
plan's collective counts, the DP's wall time against the Δt + gt¹ idle
window); the fleet prints one line per re-plan and per membership
change.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import ARCHITECTURES
from repro_torch.runtime import (CompressionConfig, ExecutionConfig,
                                 FleetConfig, MeasureConfig, NetworkConfig,
                                 PipelineConfig, RuntimeConfig,
                                 ScheduleConfig, TopologyConfig,
                                 build_runtime)


def _compression(args) -> CompressionConfig:
    scheme = args.compress or "none"
    return CompressionConfig(
        scheme=scheme,
        topk_fraction=args.topk_fraction if scheme == "topk" else None,
        error_feedback=not args.no_error_feedback)


def config_from_flags(args) -> RuntimeConfig:
    """The argparse → RuntimeConfig mapping of the ported runtimes (the
    reference launcher's, so equal flags give an equal config)."""
    name = args.runtime
    if args.staleness is not None and name in ("ps", "dynamic-ps"):
        name += "-async"
    network = topology = None
    if name in ("zero", "dynamic", "pipeline"):
        # pass the shift through even for 'zero': RuntimeConfig owns the
        # "a drift needs the run-time loop" diagnostic
        network = NetworkConfig(bandwidth_gbps=args.bw_gbps,
                                shift_gbps=args.bw_shift_gbps,
                                shift_epoch=args.shift_epoch)
    elif name != "local":
        up_shift = None
        if args.up_shift_gbps is not None:
            if args.up_shift_gbps <= 0:
                raise SystemExit(f"--up-shift-gbps must be positive, got "
                                 f"{args.up_shift_gbps}")
            up_shift = args.up_gbps / args.up_shift_gbps
        topology = TopologyConfig(
            servers=args.ps_servers,
            workers=args.ps_workers if name.endswith("async") else None,
            down_gbps=args.down_gbps, up_gbps=args.up_gbps,
            worker_flops=args.worker_flops,
            up_shift_factor=up_shift, shift_epoch=args.shift_epoch)

    fleet = None
    if args.fleet_schedule is not None and name != "fleet-async":
        raise SystemExit("--fleet-schedule scripts elastic membership; it "
                         "needs --runtime fleet-async")
    if name == "fleet-async":
        events = ()
        if args.fleet_schedule is not None:
            with open(args.fleet_schedule) as fh:
                events = tuple(json.load(fh))
        fleet = FleetConfig(events=events,
                            workers_per_shard=args.workers_per_shard)

    pipeline = None
    if name == "pipeline":
        pipeline = PipelineConfig(
            stages=args.stages or 2, microbatches=args.microbatches or 2,
            schedule=args.pipeline_schedule, chunks=args.transfer_chunks)
    elif args.stages is not None or args.microbatches is not None:
        raise SystemExit("--stages/--microbatches configure the pipeline "
                         "runtime; add --runtime pipeline")
    return RuntimeConfig(
        runtime=name, arch=args.arch, reduced=args.reduced, fleet=fleet,
        pipeline=pipeline,
        batch=args.batch, seq=args.seq, optimizer=args.optimizer, lr=args.lr,
        schedule=ScheduleConfig(
            strategy=args.strategy, reschedule_every=args.steps_per_epoch,
            drift_detect=args.drift_detect,
            async_planning=args.async_planning,
            plan_cache_size=args.plan_cache_size,
            network=network, topology=topology),
        execution=ExecutionConfig(
            zero3=args.zero3, staleness=args.staleness,
            throttle=args.throttle, aggregate=args.aggregate),
        measure=MeasureConfig(cost_source=args.cost_source,
                              compute_flops_per_s=args.worker_flops),
        compression=_compression(args))


def print_events(rt) -> None:
    """One line per scheduling pass of a dynamic runtime, then its step
    cache's first uses and hits (sync) or its per-worker plans (async)."""
    tr = getattr(rt, "trainer", None)
    for e in rt.events:
        if hasattr(e, "resharded"):              # fleet re-plan
            reshard = f" resharded→{e.num_servers} shards " \
                      f"({e.migrated_bytes / 1e6:.1f} MB moved)" \
                      if e.resharded else ""
            print(f"t={e.sim_time:8.3f} @push {e.at_push:4d}: re-plan "
                  f"({e.reason}, worker {e.worker}) — {e.num_workers} "
                  f"workers, "
                  f"{'re-segmented' if e.plan_changed else 'unchanged'}"
                  f"{reshard}  sched {e.scheduling_seconds * 1e3:.2f} ms "
                  f"hidden={e.overhead_hidden}")
        elif hasattr(e, "fleet_size"):           # fleet membership change
            print(f"t={e.sim_time:8.3f}: {e.kind} worker {e.worker} "
                  f"(fleet size {e.fleet_size})")
        elif hasattr(e, "worker_plans"):         # async per-worker re-plan
            segs = [(len(p.forward), len(p.backward))
                    for p in e.worker_plans]
            print(f"epoch {e.epoch:3d} @push {e.at_push:4d}: per-worker "
                  f"pull/push segments {segs}  "
                  f"{'re-segmented' if e.plan_changed else 'unchanged'}  "
                  f"sched {e.scheduling_seconds * 1e3:.2f} ms "
                  f"hidden={e.overhead_hidden}")
    if not hasattr(tr, "traces"):
        return
    for e in rt.events:
        if not hasattr(e, "plan"):               # an EvalEvent
            continue
        ag, rs = tr.collective_counts(e.plan)
        print(f"epoch {e.epoch:3d} step {e.step:4d}: "
              f"{len(e.plan.forward)} pull / {len(e.plan.backward)} "
              f"push segments (collectives {ag} ag / {rs} rs)  "
              f"{'re-segmented' if e.plan_changed else 'unchanged'}"
              f"{' [cache hit]' if e.plan_changed and not e.retraced else ''}"
              f"  sched {e.scheduling_seconds * 1e3:.2f} ms "
              f"hidden={e.overhead_hidden}")
    print(f"[{rt.config.runtime}] traces {tr.traces}, cache hits "
          f"{tr.cache_hits}")


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
    ap.add_argument("--runtime",
                    choices=("local", "zero", "dynamic", "ps", "dynamic-ps",
                             "ps-async", "dynamic-ps-async", "fleet-async",
                             "pipeline"),
                    default="local",
                    help="registry name; --staleness k upgrades "
                         "ps/dynamic-ps to their -async form")
    ap.add_argument("--strategy", default="dynacomm",
                    choices=("sequential", "lbl", "ibatch", "dynacomm"))
    ap.add_argument("--steps-per-epoch", type=int, default=20,
                    help="re-scheduling interval of the dynamic runtimes")
    ap.add_argument("--bw-gbps", type=float, default=10.0,
                    help="edge uplink bandwidth (Gbit/s) the plan prices")
    ap.add_argument("--bw-shift-gbps", type=float, default=None,
                    help="dynamic: drift the uplink to this bandwidth at "
                         "--shift-epoch")
    ap.add_argument("--shift-epoch", type=int, default=1)
    ap.add_argument("--async-planning", action="store_true",
                    help="dynamic runtimes: pre-plan epoch e+1's decision "
                         "during epoch e (the paper's gt¹ idle window); "
                         "decisions and losses stay bitwise the same")
    ap.add_argument("--plan-cache-size", type=int, default=256,
                    help="memoized (strategy, costs) -> decision entries "
                         "kept by the planner (LRU)")
    ap.add_argument("--cost-source", choices=("analytic", "measured"),
                    default="analytic",
                    help="dynamic runtimes: fc/bc from the analytic "
                         "profiles or measured on the device")
    ap.add_argument("--drift-detect", action="store_true",
                    help="dynamic: also re-schedule when observed step "
                         "times drift (EWMA detector)")
    ap.add_argument("--worker-flops", type=float, default=1e10,
                    help="edge-worker compute rate fed to the profiler")
    ap.add_argument("--zero3", action="store_true",
                    help="zero / ps: re-pull middle-layer weights for the "
                         "backward instead of keeping them")
    ap.add_argument("--ps-servers", type=int, default=2,
                    help="ps: number of server shards")
    ap.add_argument("--ps-workers", type=int, default=None,
                    help="async ps: logical worker count (sync ps runs "
                         "one worker per rank)")
    ap.add_argument("--staleness", type=int, default=None,
                    help="bounded-staleness k: switch the ps runtimes to "
                         "asynchronous execution")
    ap.add_argument("--throttle", choices=("reject", "wait"),
                    default="reject",
                    help="async ps: evict stale pushes (reject) or SSP "
                         "wait-at-barrier (wait)")
    ap.add_argument("--aggregate", action="store_true",
                    help="async ps wait throttle: commit same-version "
                         "pushes as one BSP step")
    ap.add_argument("--down-gbps", type=float, default=10.0,
                    help="ps: server→worker (pull) bandwidth per link")
    ap.add_argument("--up-gbps", type=float, default=1.0,
                    help="ps: worker→server (push) bandwidth per link")
    ap.add_argument("--up-shift-gbps", type=float, default=None,
                    help="dynamic-ps: degrade every uplink to this "
                         "bandwidth at --shift-epoch")
    ap.add_argument("--fleet-schedule", default=None,
                    help="fleet-async: JSON file holding a list of fleet "
                         "event dicts (time/kind/worker/...) to script "
                         "membership churn")
    ap.add_argument("--workers-per-shard", type=int, default=0,
                    help="fleet-async: let the shard count track the "
                         "fleet size (0 keeps --ps-servers fixed)")
    ap.add_argument("--stages", type=int, default=None,
                    help="pipeline: number of contiguous stages (DP-"
                         "balanced by profiled fc+bc; default 2)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="pipeline: micro-batches per step (must divide "
                         "--batch; default 2)")
    ap.add_argument("--pipeline-schedule", choices=("gpipe", "1f1b"),
                    default="1f1b",
                    help="pipeline: micro-batch order (GPipe fill/drain "
                         "or PipeDream-flush 1F1B)")
    ap.add_argument("--transfer-chunks", type=int, default=1,
                    help="pipeline: boundary-tensor chunks per micro-batch "
                         "for DynaComm-segmented activation transfers")
    ap.add_argument("--compress", choices=("none", "int8", "topk"),
                    default=None,
                    help="ps: compress gradient pushes (int8 per-tile "
                         "quantization or top-k sparsification); with "
                         "--config it replaces the config's compression")
    ap.add_argument("--topk-fraction", type=float, default=0.01,
                    help="fraction of entries kept by --compress topk")
    ap.add_argument("--no-error-feedback", action="store_true",
                    help="disable error-feedback residual accumulation "
                         "on compressed pushes")
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

    if args.config is None:
        config = config_from_flags(args)
    else:
        config = RuntimeConfig.load(args.config)
        if args.compress is not None:
            config = dataclasses.replace(config,
                                         compression=_compression(args))
    if args.dump_config:
        print(config.to_json())
        return None
    if args.steps < 1:
        raise SystemExit(f"--steps must be >= 1, got {args.steps}")

    rt = build_runtime(config, device=args.device)
    spec = f"[{config.runtime}] arch {config.arch}" + \
        (" (reduced)" if config.reduced else "") + \
        f", strategy {config.schedule.strategy}"
    if config.regime == "ps-async":
        spec += (f", k={config.execution.staleness or 0} "
                 f"({config.execution.throttle}"
                 f"{'+aggregate' if config.execution.aggregate else ''})")
    if config.runtime == "fleet-async" and config.fleet is not None:
        spec += f", fleet events {len(config.fleet.events)}" \
            if config.fleet.events else \
            f", fleet churn {config.fleet.churn}/s"
    if config.runtime == "pipeline":
        spec += (f", S={config.pipeline.stages} "
                 f"M={config.pipeline.microbatches} "
                 f"({config.pipeline.schedule})")
    print(f"{spec}, device {rt.device}")
    if config.runtime in ("zero", "ps"):
        plan = rt.plan
        print(f"[{config.runtime}] {rt.trainer.axis_size} ranks; "
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

    print_events(rt)
    led = rt.ledger
    unit = "units" if config.regime == "ps-async" else "steps"
    print(f"[{config.runtime}] {len(losses)} {unit}, final loss "
          f"{losses[-1]:.4f}; transfers: "
          f"{led['pull_bytes'] / 1e6:.1f} MB down / "
          f"{led['push_bytes'] / 1e6:.1f} MB up "
          f"({led['num_pulls']} pulls, {led['num_pushes']} pushes)")
    if config.compression.enabled:
        print(f"[{config.runtime}] push wire "
              f"{led['push_wire_bytes'] / 1e6:.1f} MB "
              f"({config.compression.scheme}, "
              f"{led['push_compression_ratio']:.2f}x vs fp32)")
    if config.regime == "ps-async":
        log = rt.timeline()
        print(f"[{config.runtime}] {len(log.accepted)} accepted / "
              f"{log.num_rejected} rejected pushes, max staleness "
              f"{log.max_staleness}, waited {led['waited_pushes']} "
              f"({log.total_wait_s:.3f} simulated s), makespan "
              f"{log.makespan:.3f} simulated s")
    if args.checkpoint:
        rt.save_state(args.checkpoint)
        print(f"saved runtime state to {args.checkpoint}")
    return losses


if __name__ == "__main__":
    main()
