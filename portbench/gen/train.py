"""Training traffic: a closed loop of steps of one registered runtime.

The traffic file gives the runtime's config (``runtime_config``: what
``repro_torch.runtime.RuntimeConfig`` takes, without the architecture and
the seed), ``batch`` x ``seq``, the token distribution, AdamW's learning rate
(``lr``; its other hyperparameters are the port's defaults, which the
reference shares), and four counts:

* ``unit_steps``: the window's unit (1, or a re-plan epoch), so that the
  window starts and ends on a unit boundary;
* ``check_steps``: the first steps the reference follows;
* ``setup_steps``: the steps set-up drives before the window (the checked
  ones first; a whole number of units, so that every shape and every
  measurement pass has run once);
* ``traced_units``: the units traced with ``--trace 1``.

Set-up builds the runtime, writes the benchmark's weights into its state
and drives its first steps through the window's own call (``fit(1)``) and
feed.  The program's readings are taken from its state as they stand:
the first gradient from AdamW's first moment after step 1, the change
after the last checked step.  The window then runs units until
``--seconds`` have passed.  Once it has closed and the peak memory is
read, the runtime is freed and the reference follows the checked steps
from the same weights and batches.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import families
from portbench.counts import bucket_pack
from portbench.gen.common import sync
from portbench.harness import checks, weights
from portbench.harness.runner import Outcome
from portbench.harness.trace import traced
from portbench.reference import train as reference


class Feed:
    """Batch ``i`` of the cell, made on the device from the seed: tokens
    from a Zipf marginal over the vocabulary (rank r has weight 1 / r),
    labels a fixed permutation of the tokens (learnable structure, as the
    port's ``SyntheticText``).  Tokens come from uniform draws through the
    marginal's inverse CDF (``torch.rand``, ``searchsorted``): the same
    seed gives the same tokens, call after call.  (``torch.multinomial`` on
    the card does not: two calls from one seed gave two batches.)  The
    permutation is drawn once on the host."""

    def __init__(self, cfg, traffic, seed: int, device):
        v = cfg["vocab_size"]
        self.b, self.t, self.seed = traffic["batch"], traffic["seq"], seed
        if traffic["tokens"] != "zipf":
            raise ValueError(f"unknown token distribution "
                             f"{traffic['tokens']!r}")
        w = 1.0 / np.arange(1, v + 1, dtype=np.float64)
        cdf = np.cumsum(w / w.sum())
        cdf[-1] = 1.0
        self.cdf = torch.from_numpy(cdf).to(device)
        perm = np.random.default_rng(weights.subseed(seed, 2, 0)) \
            .permutation(v)
        self.perm = torch.from_numpy(perm).to(device)
        self.gen = torch.Generator(device=device)

    def __call__(self, i: int) -> Dict[str, torch.Tensor]:
        self.gen.manual_seed(weights.subseed(self.seed, 3, i))
        u = torch.rand(self.b * self.t, generator=self.gen,
                       dtype=torch.float64, device=self.cdf.device)
        toks = torch.searchsorted(self.cdf, u, right=True).clamp_(
            max=self.cdf.numel() - 1).view(self.b, self.t)
        return {"tokens": toks, "labels": self.perm[toks]}


def build(cfg, traffic, seed: int, device):
    from repro_torch.runtime import RuntimeConfig, build_runtime
    arch = families.of(cfg).arch_for(cfg)
    rc = dict(traffic["runtime_config"])
    rc.update(arch=arch.name, reduced=False, seed=seed % 2 ** 31,
              batch=traffic["batch"], seq=traffic["seq"],
              optimizer="adamw", lr=traffic["lr"],
              aux_weight=cfg.get("router_aux_loss_coef", 0.0))
    feed = Feed(cfg, traffic, seed, device)
    rt = build_runtime(RuntimeConfig.from_dict(rc), model=arch, data=feed,
                       device=device)
    return rt, feed


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x, dtype=torch.float64))


def drive_checked(rt, cfg, traffic, seed: int, device) -> Dict[str, Any]:
    """The checked steps, through ``fit(1)``; the program's readings."""
    trainer = rt._layout
    losses: List[float] = []
    grads: Dict[Any, float] = {}
    for step in range(1, traffic["check_steps"] + 1):
        losses.append(rt.fit(1)[0])
        if step == 1:
            grads = {leaf: norm(m) / (1.0 - reference.B1) for leaf, m in
                     weights.state_leaves(cfg, trainer,
                                          rt._state["opt"].mu)}
    drawn = weights.draw(cfg, seed, device)
    change = {leaf: norm(p - weights.get(drawn, leaf)) for leaf, p in
              weights.state_leaves(cfg, trainer, rt._state["flat_params"])}
    del drawn
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def window(rt, seconds: float, unit: int) -> Dict[str, Any]:
    """Whole units of ``fit(1)`` steps until ``seconds`` have passed:
    each step's seconds, whether a re-plan event came with it, its loss."""
    steps = []
    start = time.perf_counter()
    while True:
        for _ in range(unit):
            n = len(rt.events)
            t = time.perf_counter()
            loss = rt.fit(1)[0]
            steps.append((time.perf_counter() - t, len(rt.events) > n, loss))
        if time.perf_counter() - start >= seconds:
            break
    return {"seconds": time.perf_counter() - start, "steps": steps}


@contextlib.contextmanager
def moe_spans(kept: list):
    """Spans around the port's MoE layer and its router, from the
    benchmark's side (``record_function``), and each routing's kept mask
    into ``kept``.  Only the traced run installs them."""
    from torch.profiler import record_function
    from repro_torch.models import blocks, moe
    route, apply_moe = moe.route, blocks.apply_moe

    def spanned_route(probs, cfg, cap):
        with record_function("portbench.moe.route"):
            r = route(probs, cfg, cap)
        kept.append(r.keep)
        return r

    def spanned_apply(params, x, cfg):
        with record_function("portbench.moe.apply"):
            return apply_moe(params, x, cfg)

    moe.route, blocks.apply_moe = spanned_route, spanned_apply
    try:
        yield
    finally:
        moe.route, blocks.apply_moe = route, apply_moe


def traced_units(rt, cfg, traffic, device, work_dir):
    """The traced units: (what the readers read of them, the trace)."""
    from repro_torch.kernels import launch_counts
    unit = traffic["unit_steps"]
    n = traffic["traced_units"] * unit
    kept: List[torch.Tensor] = []
    before = launch_counts()
    moe = cfg.get("num_local_experts", 0) > 0
    with moe_spans(kept) if moe else contextlib.nullcontext():
        trace = traced(lambda: (rt.fit(n), sync(device)), work_dir,
                       device.type == "cuda")
    after = launch_counts()
    delta = {k: after[k] - before.get(k, 0) for k in after}
    trainer = rt._layout
    specs = [(s.total, s.padded, s.axis_size) for s in trainer.specs]
    plan = (rt.plan.forward, rt.plan.backward)
    facts = {"steps": n,
             "copy_bytes": n * bucket_pack.step_bytes(specs, plan),
             "copy_launches_expected": n * bucket_pack.launches(plan),
             "flash_calls": [{"b": traffic["batch"],
                              "h": cfg["num_attention_heads"],
                              "hkv": cfg["num_key_value_heads"],
                              "t": traffic["seq"], "hd": cfg["head_dim"],
                              "causal": True, "window": 0}]
             * delta.get("flash_attention_fwd", 0),
             "copy_launches_in_trace": trace.count(bucket_pack.KERNEL)}
    if kept:
        facts["kept_fraction"] = float(
            sum(k.sum() for k in kept) / sum(k.numel() for k in kept))
    return facts, trace


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        work_dir) -> Outcome:
    cfg, traffic = cell.config, cell.traffic
    rt, feed = build(cfg, traffic, seed, device)
    drawn = weights.draw(cfg, seed, device)
    weights.load_into_state(cfg, drawn, rt._layout, rt._state)
    del drawn
    prog = drive_checked(rt, cfg, traffic, seed, device)
    extra = traffic["setup_steps"] - traffic["check_steps"]
    if extra:
        rt.fit(extra)
    sync(device)
    setup_s = time.perf_counter() - t0

    win = window(rt, seconds, traffic["unit_steps"])
    tokens = traffic["batch"] * traffic["seq"]
    losses = [s[2] for s in win["steps"]]
    facts: Dict[str, Any] = {"window": win}
    tr = None
    if trace:
        traced_facts, tr = traced_units(rt, cfg, traffic, device, work_dir)
        facts["traced"] = traced_facts
    facts["model_flops"] = len(win["steps"]) * families.of(cfg).flops \
        .train_step(
        cfg, traffic["batch"], traffic["seq"],
        facts.get("traced", {}).get("kept_fraction"))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    events = len(rt.events)

    del rt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    drawn = weights.draw(cfg, seed, device)
    batches = [feed(i) for i in range(traffic["check_steps"])]
    ref = reference.run(cfg, drawn, batches, traffic["lr"])
    del drawn, batches
    numbers = checks.train_numbers(prog, ref)
    where = numbers.pop("where")
    failed = sum(1 for x in losses + prog["losses"] if not math.isfinite(x))
    return Outcome(
        e2e={"train_tokens_per_s": len(win["steps"]) * tokens
             / win["seconds"], "setup_s": setup_s},
        numbers=numbers, attempted=len(win["steps"]), failed=failed,
        peak_bytes=peak, facts=facts, trace=tr,
        notes={"numbers": numbers, "where": where, "replan_events": events,
               "window_steps": len(win["steps"]),
               "losses_checked": prog["losses"],
               "losses_reference": ref["losses"]})
