"""DynaComm's bucketed ZeRO trainer at production scale, as a dry run.

For each scheduling strategy: the plan, the paper's objective f_m and a
beyond-paper steady-state pipelining bound (double-buffered
cross-iteration overlap), all under the reference's **TPU cost model**
(``core.TPUSystemModel``: the ``fm_*`` and ``steady_state_s`` numbers are
the model's seconds for a TPU pod, not a measurement of any card).

Without ``--skip-lowering`` the port's own ``ZeroTrainer`` then takes one
step of the plan in a fake world of 256 ranks (``launch/fake.py``: the
``"fake"`` process-group backend, fake CPU tensors, nothing allocated or
moved, no card), inside ``analysis/trace.py::record_collectives``.  Each
strategy's record adds what that step launched, in place of the
reference's numbers read off its compiled HLO:

* ``recorded_all_gathers`` / ``recorded_reduce_scatters`` (the
  reference's ``hlo_all_gathers`` / ``hlo_reduce_scatters``): must equal
  ``fwd_buckets`` / ``bwd_buckets``;
* ``all_gather_bytes`` / ``reduce_scatter_bytes`` and their sum with the
  loss's all-reduce, ``operand_bytes_per_device`` (the reference's
  ``coll_bytes_per_device``), by the recorder's operand convention;
* ``peak_live_bytes``: the most bytes the step held at once on top of the
  state, from the fake allocations (in place of the reference's
  ``temp_bytes``, XLA's temporary buffers).

Usage: PYTHONPATH=src python -m repro_torch.launch.zero_dryrun
[--arch granite-3-2b] [--skip-lowering] [--reduced]
[--strategies sequential,lbl,ibatch,dynacomm]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import (LayerCosts, TPUSystemModel,
                              costs_from_profiles, evaluate,
                              plan_from_decision, schedule)
from repro_torch.launch.mesh import make_zero_mesh
from repro_torch.models import num_sched_layers
from repro_torch.models.profiles import layer_profiles

STRATEGIES = ("sequential", "lbl", "ibatch", "dynacomm")


def tpu_costs(arch: str, shape_name: str, data_axis: int,
              cfg=None) -> LayerCosts:
    """The TPU cost model's per-layer costs (``cfg`` overrides the arch's
    published config, e.g. with a reduced one)."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    profs = layer_profiles(cfg, shape)
    # per-device compute: global layer FLOPs / data shards
    profs = [type(p)(name=p.name, param_bytes=p.param_bytes,
                     flops_fwd=p.flops_fwd / data_axis) for p in profs]
    net = TPUSystemModel(data_axis_size=data_axis)
    return costs_from_profiles(profs, net=net)


def steady_state_bound(costs: LayerCosts, decision) -> float:
    """Beyond-paper: double-buffered cross-iteration pipelining.

    With weights double-buffered, iteration i+1's pulls overlap iteration
    i's backward; steady-state iteration time = max(link busy, compute
    busy) instead of the paper's serial fwd-phase + bwd-phase.
    """
    (fsegs, bsegs) = decision
    n = len(fsegs) + len(bsegs)
    link = n * costs.dt + float(np.sum(costs.pt) + np.sum(costs.gt))
    comp = float(np.sum(costs.fc) + np.sum(costs.bc))
    return max(link, comp)


def fake_step(cfg, plan, shape, world: int) -> dict:
    """One ``ZeroTrainer`` step of ``plan`` on fake tensors in the fake
    world (which must exist): the recorded collectives and the step's
    peak of live bytes."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.trace import collective_summary, \
        record_collectives
    from repro_torch.dist.zero import ZeroTrainer
    from repro_torch.launch.fake import (LiveBytes, constant_step,
                                         fake_mode)
    from repro_torch.optim import adamw
    tr = ZeroTrainer(cfg=cfg, plan=plan, optimizer=adamw(1e-4),
                     device="cpu", group=dist.group.WORLD)
    if tr.axis_size != world:
        raise ValueError(f"the fake world has {tr.axis_size} ranks, "
                         f"not {world}")
    with fake_mode():
        shards = [torch.empty(spec.shard_size) for spec in tr.specs]
        state = {"flat_params": shards,
                 "opt": constant_step(tr.optimizer.init(shards)),
                 "step": torch.zeros((), dtype=torch.int32)}
        b, t = shape.global_batch, shape.seq_len
        batch = {"tokens": torch.empty((b, t), dtype=torch.int64),
                 "labels": torch.empty((b, t), dtype=torch.int64)}
        with LiveBytes() as live, record_collectives() as trace:
            tr.step(state, batch)
    summary = collective_summary(trace)
    ag, rs = summary["all-gather"], summary["reduce-scatter"]
    return {
        "recorded_all_gathers": len(ag),
        "recorded_reduce_scatters": len(rs),
        "all_gather_bytes": sum(n for _, n in ag),
        "reduce_scatter_bytes": sum(n for _, n in rs),
        "operand_bytes_per_device": sum(r.bytes for r in trace),
        "peak_live_bytes": live.peak,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--skip-lowering", action="store_true",
                    help="only the plans and the cost model: no fake step")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (a smoke check)")
    ap.add_argument("--strategies", default=",".join(STRATEGIES),
                    help="comma-separated subset of the four strategies "
                         "(the comparisons need sequential and dynacomm)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    mesh = make_zero_mesh()
    data_axis = mesh.shape["data"]
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = INPUT_SHAPES[args.shape]
    costs = tpu_costs(args.arch, args.shape, data_axis, cfg)
    Ls = num_sched_layers(cfg)
    if not args.skip_lowering:
        import warnings
        from repro_torch.launch.fake import init_fake_world
        # torch deprecates the collectives' tensor forms, one line a call
        warnings.filterwarnings(
            "ignore", message=r"`torch\.distributed\.\w+` is deprecated")
        init_fake_world(data_axis)

    results = {"arch": args.arch, "shape": args.shape,
               "mesh": f"zero-{data_axis}", "dt_tpu": costs.dt,
               "strategies": {}}
    if not args.skip_lowering:
        results["fake_world"] = data_axis
    strategies = args.strategies.split(",")
    unknown = set(strategies) - set(STRATEGIES)
    if unknown:
        ap.error(f"unknown strategies {sorted(unknown)}")
    for strat in strategies:
        decision = schedule(costs, strat)
        plan = plan_from_decision(*decision, Ls)
        times = evaluate(costs, decision)
        rec = {
            "fwd_buckets": len(plan.forward),
            "bwd_buckets": len(plan.backward),
            "fm_iteration_s": times["total"],
            "fm_forward_s": times["forward"],
            "fm_backward_s": times["backward"],
            "steady_state_s": steady_state_bound(costs, decision),
        }
        if not args.skip_lowering:
            rec.update(fake_step(cfg, plan, shape, data_axis))
        results["strategies"][strat] = rec
        print(strat, json.dumps(rec), flush=True)

    recs = results["strategies"]
    if "sequential" in recs and "dynacomm" in recs:
        seq = recs["sequential"]["fm_iteration_s"]
        dyn = recs["dynacomm"]["fm_iteration_s"]
        pipe = recs["dynacomm"]["steady_state_s"]
        results["dynacomm_vs_sequential_pct"] = round(100 * (1 - dyn / seq),
                                                      2)
        results["pipelined_vs_dynacomm_pct"] = round(100 * (1 - pipe / dyn),
                                                     2)
        print("dynacomm reduces iteration by",
              results["dynacomm_vs_sequential_pct"], "% vs sequential;"
              " beyond-paper pipelining adds",
              results["pipelined_vs_dynacomm_pct"], "% on top")
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(results) + "\n")
    return results


if __name__ == "__main__":
    main()
