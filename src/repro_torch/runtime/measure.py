"""Measured per-sched-layer fc/bc timings (the mxnet.profiler analogue).

Both dynamic trainers share one implementation, called from
:meth:`repro_torch.runtime.replan.ReplanMixin.measured_times`: each sched
layer's forward apply and VJP (``models/model.py``'s per-sched-layer
program) runs standalone and is timed into a
:class:`repro_torch.core.profiler.LayerTimingHook`.  The ZeRO and PS
trainers share the flat-buffer state layout, so the same routine measures
either — the PS trainer additionally rescales the timings to each worker's
compute rate (:meth:`repro_torch.ps.topology.PSTopology.topology_costs_measured`).

On a CUDA device each call is timed by CUDA events recorded on the
current stream around it (device time, read back once the layer's calls
are queued); on the CPU by ``LayerTimingHook.timed`` (host clock around
the blocking call).  The hook drops its ``warmup`` samples per key: they
absorb the first launch and any kernel build.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.models import model as model_lib


def measurement_due(fc_bc: Optional[Tuple], measured_epoch: int,
                    epoch: int, remeasure_every: int, *,
                    force: bool = False) -> bool:
    """The shared re-measurement rule of both dynamic trainers: measure
    when nothing is cached, when forced (a drift detector fired), or when
    the cache is ``remeasure_every`` re-plan epochs old
    (``remeasure_every == 0`` ⇒ measure once and keep it)."""
    stale = (remeasure_every > 0 and
             epoch - measured_epoch >= remeasure_every)
    return fc_bc is None or stale or force


def _sample(hook, phase: str, layer: int, fn: Callable, calls: int,
            device: torch.device) -> None:
    """``calls`` timed calls of ``fn()`` recorded under (phase, layer)."""
    if device.type != "cuda":
        timed = hook.timed(phase, layer, fn)
        for _ in range(calls):
            timed()
        return
    stream = torch.cuda.current_stream(device)
    pairs = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        fn()
        end.record(stream)
        pairs.append((start, end))
    pairs[-1][1].synchronize()
    for start, end in pairs:
        hook.record(phase, layer, start.elapsed_time(end) / 1e3)


def measure_layer_times(cfg, layout, state, batch, hook, *,
                        aux_weight: float, device: torch.device,
                        iters: int) -> None:
    """Record ``hook.warmup + iters`` fc/bc time samples per sched layer
    into ``hook`` (resetting it first).

    ``layout`` is the trainer that owns ``state``'s layout (anything with
    ``params_from_state``: the ZeRO trainer or the PS trainer).  Each
    layer runs its own forward apply (under ``no_grad``, as the step's
    forward does) and its VJP — the forward recomputed under autograd plus
    the backward, in one call, as the reference's ``jax.vjp`` times it and
    as the step's backward runs it — on the whole ``batch``, on
    ``device``, through ``models/model.py``'s per-sched-layer program.
    Layers of one kind share their inputs (the embedding's output and a
    ones cotangent), as in the reference; a block's VJP pulls back
    (output, aux) with the cotangent (ones, ``aux_weight``), so an MoE
    block's cost includes the router's backward.
    """
    with tracing.span("runtime.measure"):
        _measure(cfg, layout, state, batch, hook, aux_weight, device, iters)


def _measure(cfg, layout, state, batch, hook, aux_weight: float,
             device: torch.device, iters: int) -> None:
    kinds = cfg.layer_kinds()
    calls = hook.warmup + iters
    batch = {k: v.to(device) for k, v in batch.items()}
    trees = model_lib.sched_layer_trees(layout.params_from_state(state))
    Ls = len(trees)
    hook.reset()

    def embed(pe):
        return model_lib.apply_embed(cfg, pe, batch)

    def block(p, hh, kind):
        return model_lib.apply_train_block(cfg, p, hh, kind)

    def final(pf, pe, hh):
        return model_lib.apply_final(cfg, pf, pe, hh, batch)

    vjp = model_lib.layer_vjp
    with torch.no_grad():
        h0 = embed(trees[0])
    ct_h = torch.ones_like(h0)
    aux_ct = (torch.full((), aux_weight, dtype=torch.float32,
                         device=device) if cfg.is_moe else None)

    def fwd(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    _sample(hook, "fc", 0, fwd(lambda: embed(trees[0])), calls, device)
    _sample(hook, "bc", 0, lambda: vjp(embed, (trees[0],), ct_h),
            calls, device)
    for l in range(1, Ls - 1):
        kind = kinds[l - 1]
        _sample(hook, "fc", l, fwd(
            lambda l=l, kind=kind: block(trees[l], h0, kind)), calls, device)
        _sample(hook, "bc", l, lambda l=l, kind=kind: vjp(
            lambda p, hh: block(p, hh, kind), (trees[l], h0),
            (ct_h, model_lib.aux_cotangent(cfg, l, aux_ct))), calls, device)
    _sample(hook, "fc", Ls - 1, fwd(
        lambda: final(trees[Ls - 1], trees[0], h0)), calls, device)
    _sample(hook, "bc", Ls - 1, lambda: vjp(
        final, (trees[Ls - 1], trees[0], h0), None), calls, device)
