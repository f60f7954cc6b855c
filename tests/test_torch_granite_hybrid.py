"""granite-4.0-h-small on the port, on the CPU: the reduced hybrid trained
through ``build_runtime(config).fit`` against the benchmark's plain
reference (``portbench/reference/granite_hybrid.py``), the expert share
against the whole layer, the MoE counters, and the preset's sizes.

The reduced model is the benchmark's test-size file
(``portbench/tests/data/granite-hybrid-tiny.json``: 7 layers, a whole
period of 5 Mamba-2, 1 NoPE attention and one more Mamba-2, experts 2-5 of
8 held, top-2, a capacity that drops, chunk 8 over T = 16), with the
benchmark's own feed and weights.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.families import granite_hybrid as family
from portbench.gen import train as gen_train
from portbench.harness import checks, weights
from portbench.reference import granite_hybrid as ref
from portbench.reference import train as ref_train
from repro_torch import tracing
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.models.layers import apply_mlp

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "portbench" / "tests" / "data" / "granite-hybrid-tiny.json"
TRAFFIC = {"batch": 2, "seq": 16, "tokens": "zipf", "lr": 3e-4,
           "runtime_config": {"runtime": "zero",
                              "schedule": {"strategy": "dynacomm"}}}


def _tiny():
    f = json.loads(TINY.read_text())
    return {**f, **f["departs"]}


def test_three_steps_of_fit_are_the_references():
    """Losses, every leaf's first gradient and its change over 3 AdamW
    steps.  The two sides are float32 sums in other orders: the loss
    within 1e-6 (~10x its rounding), gradients within 2e-5 of each
    leaf's norm, changes within 2e-4 (AdamW's first updates move each
    weight by ~lr in the sign of its gradient, so a gradient element at
    rounding level can take either sign)."""
    cfg, seed = _tiny(), 2 ** 31 + 11
    rt, feed = gen_train.build(cfg, TRAFFIC, seed, torch.device("cpu"))
    assert rt._layout.cfg.layer_kinds().count("mamba2") == 6
    drawn = weights.draw(cfg, seed, "cpu")
    weights.load_into_state(cfg, drawn, rt._layout, rt._state)
    prog = gen_train.drive_checked(rt, cfg, dict(TRAFFIC, check_steps=3),
                                   seed, torch.device("cpu"))
    want = ref_train.run(cfg, drawn, [feed(i) for i in range(3)],
                         TRAFFIC["lr"])
    n = checks.train_numbers(prog, want)
    assert n["loss_gap"] < 1e-6, n["where"]
    assert n["grad_gap"] < 2e-5, n["where"]
    assert n["change_gap"] < 2e-4, n["where"]
    assert len(prog["grad_norms"]) == len(want["grad_norms"])
    assert want["losses"][2] < want["losses"][0]


def _layer(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    whole = moe.init_moe_params(gen, cfg)
    shared = {k: torch.randn(s, generator=gen) * 0.2 for k, s in
              (("gate", (cfg.d_model, 24)), ("up", (cfg.d_model, 24)),
               ("down", (24, cfg.d_model)))}
    x = torch.randn(3, 11, cfg.d_model, generator=gen)
    return whole, shared, x


def _ref_cfg(cfg, first, held):
    return {"num_router_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.top_k,
            "capacity_factor": cfg.capacity_factor,
            "first_local_expert": first, "num_local_experts": held}


def test_four_shares_add_up_to_the_whole_layer():
    """An 8-expert layer, top-2, a capacity that drops, cut into four
    shares of 2 experts: their outputs, with the shared expert counted
    once, add up to the uncut layer's (the port's and the reference's),
    and every share's aux is the whole router's."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(
        d_model=32), num_experts=8, top_k=2, capacity_factor=0.5)
    whole, shared, x = _layer(cfg)
    out, aux = moe.apply_moe(whole, x, cfg)
    parts = []
    for i in range(4):
        share = dataclasses.replace(cfg, experts_first=2 * i, experts_held=2)
        p = {"router": whole["router"],
             **{k: whole[k][2 * i:2 * i + 2] for k in ("gate", "up", "down")}}
        y, a = moe.apply_moe(p, x, share)
        assert torch.equal(a, aux)
        parts.append(y)
    s = apply_mlp(shared, x, "silu")
    total = sum(parts) + s
    assert torch.allclose(total, out + s, rtol=0, atol=1e-6)
    want, want_aux = ref.moe(_ref_cfg(cfg, 0, 8), x, whole["router"],
                             whole["gate"], whole["up"], whole["down"])
    assert torch.allclose(total, want + s, rtol=0, atol=1e-5)
    assert torch.allclose(aux, want_aux, rtol=1e-6)
    kept = moe.route(torch.softmax(x.reshape(-1, 32) @ whole["router"], -1),
                     cfg, moe.expert_capacity(33, cfg)).keep
    assert 0 < int(kept.sum()) < kept.numel()        # the capacity drops


def test_the_counters_count_routed_held_and_kept():
    """``moe.routed``: every assignment; ``moe.assignments``: those to the
    experts held; ``moe.kept``: the held ones within capacity."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(
        d_model=32), num_experts=8, top_k=2, capacity_factor=0.5,
        experts_first=2, experts_held=3)
    gen = torch.Generator().manual_seed(3)
    probs = torch.softmax(torch.randn(40, 8, generator=gen), dim=-1)
    cap = moe.expert_capacity(40, cfg)
    tracing.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        r = moe.route(probs, cfg, cap)
    c = tracing.counters()
    tracing.reset_counters()
    held = (r.top_e >= 2) & (r.top_e < 5)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :2]
    pos = {e: 0 for e in range(8)}
    kept = 0
    for e in top.reshape(-1).tolist():
        kept += int(2 <= e < 5 and pos[e] < cap)
        pos[e] += 1
    assert c == {"moe.routed": 80, "moe.assignments": int(held.sum()),
                 "moe.kept": kept}
    assert int(r.keep.sum()) == kept and 0 < kept < int(held.sum())
    assert torch.all(r.slot[r.keep] < 3 * cap)


def test_the_preset_is_the_published_model_and_a_port_architecture():
    cfg = get_config("granite-4.0-h-small")
    assert "granite-4.0-h-small" not in ARCHITECTURES
    kinds = cfg.layer_kinds()
    assert len(kinds) == 40 and kinds.count("global_attn") == 4
    assert [i for i, k in enumerate(kinds) if k == "global_attn"] \
        == [5, 15, 25, 35]
    assert (cfg.mamba_inner, cfg.mamba_conv_dim) == (8192, 8448)
    stage = dataclasses.replace(cfg, num_layers=10, experts_held=8)
    sizes = [b // 4 for b in model_lib.sched_layer_bytes(stage)]
    assert sizes[:3] == [411_041_792, 196_961_920, 196_961_920]
    assert sizes[6] == 136_617_984 and sizes[-1] == 4096
    assert sum(sizes) == 2_320_321_152


def test_the_benchmark_file_is_the_preset_cut_to_a_stage():
    f = json.loads((ROOT / "portbench" / "configs" /
                    "granite-4.0-h-small.json").read_text())
    arch = family.arch_for({**f, **f["departs"]})
    assert (arch.num_layers, arch.num_experts, arch.num_held_experts) \
        == (10, 72, 8)
    assert f["layer_types"] == ["mamba"] * 5 + ["attention"] \
        + ["mamba"] * 4
    with pytest.raises(ValueError):
        family.arch_for({**f, **f["departs"], "mamba_d_state": 64})
