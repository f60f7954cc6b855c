"""Moonlight-16B-A3B on the port, on the CPU: latent attention, the sigmoid
router with its correction bias, the leading dense layer and the whole
reduced model trained through ``build_runtime(config).fit``, each against
the benchmark's plain reference (``portbench/reference/deepseek_v3.py``);
the expert share against the whole layer; prefill and decode through the
latent cache against the full forward; the preset's sizes.

The reduced model is the benchmark's test-size file
(``portbench/tests/data/moonlight-tiny.json``: 3 layers, the dense layer 0
and 2 MoE layers, MLA of 4 heads with q / k 16 + 8 and v 16 over a latent
of 16, experts 2-5 of 8 held, top-2, a capacity that drops), with the
benchmark's own feed and weights.  Tolerances: the two sides compute the
same float32 operations in other orders, so values agree to a few
roundings (~1e-7 relative) and gradients summed over tokens to ~1e-6 of a
leaf's scale; each limit below is ~10x what its comparison reads.
"""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench.families import deepseek_v3 as family
from portbench.gen import train as gen_train
from portbench.harness import checks, weights
from portbench.reference import deepseek_v3 as ref
from portbench.reference import train as ref_train
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention, blocks, moe, profiles
from repro_torch.models import model as model_lib
from repro_torch.models.layers import apply_mlp
from repro_torch.serve import decode

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "portbench" / "tests" / "data" / "moonlight-tiny.json"
TRAFFIC = {"batch": 2, "seq": 16, "tokens": "zipf", "lr": 3e-4,
           "runtime_config": {"runtime": "zero",
                              "schedule": {"strategy": "dynacomm"}}}
REFERENCE_SET = {"granite-moe-1b-a400m", "xlstm-350m", "llava-next-34b",
                 "gemma3-4b", "hubert-xlarge", "gemma-7b", "granite-3-2b",
                 "grok-1-314b", "gemma2-2b", "recurrentgemma-2b"}


def _tiny():
    f = json.loads(TINY.read_text())
    return {**f, **f["departs"]}


def _arch():
    """The reduced model's architecture; the routing record that
    ``arch_for`` arms is taken off again, so that the reference meets no
    record of the program here."""
    arch = family.arch_for(_tiny())
    family.record_routing(0)
    return arch


@pytest.fixture(autouse=True)
def _no_routing_record():
    """No test leaves the port's ``route`` recorded for the next."""
    yield
    family.record_routing(0)


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("steps", [1, 3])
def test_fit_is_the_references(steps):
    """Losses, every leaf's first gradient and its change over 1 and 3
    AdamW steps of the reduced model through ``fit``.  The loss within
    1e-6 (~10x its rounding), gradients within 5e-6 of each leaf's norm,
    changes within 1e-4 (AdamW's first updates move each weight by ~lr in
    the sign of its gradient, so a gradient element at rounding level can
    take either sign).  The correction bias has no gradient: the program
    leaves it as drawn."""
    cfg, seed = _tiny(), 2 ** 31 + 11
    rt, feed = gen_train.build(cfg, TRAFFIC, seed, torch.device("cpu"))
    assert rt._layout.cfg.mlp_kinds() == ("dense", "moe", "moe")
    drawn = weights.draw(cfg, seed, "cpu")
    weights.load_into_state(cfg, drawn, rt._layout, rt._state)
    prog = gen_train.drive_checked(rt, cfg, dict(TRAFFIC, check_steps=steps),
                                   seed, torch.device("cpu"))
    want = ref_train.run(cfg, drawn, [feed(i) for i in range(steps)],
                         TRAFFIC["lr"])
    n = checks.train_numbers(prog, want)
    assert n["loss_gap"] < 1e-6, n["where"]
    assert n["grad_gap"] < 5e-6, n["where"]
    assert n["change_gap"] < 1e-4, n["where"]
    bias = {k: v for k, v in prog["change_norms"].items()
            if k[0] == "router_bias"}
    assert len(bias) == 2 and set(bias.values()) == {0.0}
    assert set(prog["grad_norms"]) - set(want["grad_norms"]) == set(bias)


def _block_params(cfg, layer):
    """The drawn weights of one layer, as the port's block tree and as
    the reference's leaves in ``block``'s order."""
    drawn = weights.draw(cfg, 2 ** 31 + 5, "cpu")
    tree = weights.program_params(cfg, drawn)["layers"][layer]
    kind, leaves = ref._layer_leaves(cfg, ref.params_from_stacked(
        cfg, drawn))[layer]
    return tree, kind, leaves


def test_the_checked_steps_routing_is_recorded_then_handed_back():
    """Building the program through the family records its routing: every
    call of ``moe.route`` in the first 3 steps (a forward and a recompute
    a MoE layer a step), the same routing the layer took; then ``route``
    is the port's own function again."""
    own = getattr(moe.route, "recording", moe.route)
    cfg, seed = _tiny(), 2 ** 31 + 13
    rt, _ = gen_train.build(cfg, TRAFFIC, seed, torch.device("cpu"))
    assert moe.route is not own
    weights.load_into_state(cfg, weights.draw(cfg, seed, "cpu"),
                            rt._layout, rt._state)
    rt.fit(3)
    assert moe.route is own
    assert len(family.ROUTED) == 2 * 2 * 3
    forward, recompute = family.ROUTED[0], family.ROUTED[3]
    assert torch.equal(forward[0], recompute[0])      # layer 1 both times
    assert torch.equal(forward[1], recompute[1])
    assert forward[0].shape == (2 * 16, 2)
    assert forward[1].shape == (2 * 16 * 2,)
    rt.fit(1)
    assert len(family.ROUTED) == 12


def _near_tie_case():
    """32 tokens over 8 experts, top-2, and the program's routing of them
    as recorded: the reference's own at every token but two.  Token 0's
    second and third experts lie 5e-8 apart, and the program took the
    third; token 1's program set passes over its second expert for its
    last, 0.5 below."""
    cfg = _ref_moe_cfg(_router_cfg(capacity_factor=8.0, experts_first=0,
                                   experts_held=8), 0, 8)
    gen = torch.Generator().manual_seed(3)
    z = torch.rand(32, 8, generator=gen) * 0.4 + 0.3
    z[1] = torch.linspace(0.9, 0.2, 8)
    own = torch.sort(z, dim=-1, descending=True, stable=True)[1][:, :2]
    third = torch.sort(z[0], descending=True, stable=True)[1][2]
    z[0, third] = z[0, own[0, 1]] - 5e-8
    prog = own.clone()
    prog[0, 1] = third
    prog[1, 1] = 7
    keep = ref.kept(cfg, prog).reshape(-1)
    return cfg, z, own, prog, keep


def test_the_reference_decides_a_near_tie_as_the_program_did():
    """Where the program's set differs from the reference's own by a
    near-tie (every chosen expert at most ``TIE`` below every one passed
    over), the reference takes the program's; a wider difference stays
    its own.  The witness counts both and the widest gap taken."""
    cfg, z, own, prog, keep = _near_tie_case()
    family.ROUTED[:] = [(prog.to(torch.int16), keep)]
    ref.WITNESS.clear()
    settled = ref.settle_ties(cfg, own, z)
    assert torch.equal(settled[0], prog[0])
    assert torch.equal(settled[1], own[1])
    assert torch.equal(settled[2:], own[2:])
    w = ref.WITNESS[0]
    assert (w["differ"], w["adopted"]) == (2, 1)
    assert 0.0 <= w["widest_adopted"] <= ref.TIE
    assert w["narrowest_refused"] == pytest.approx(
        float(z[1, own[1, 1]] - z[1, 7]))
    assert w["held"] == 64 and w["held_kept"] == 64      # capacity 8.0
    # no capacity binds; after, the refused token's two flags differ
    assert (w["capacity_flips"], w["keep_differs_after"]) == (0, 2)


def test_a_settled_tie_moves_the_capacity_cut_as_the_program_did():
    """Top-1 of 4 experts, 8 tokens, a capacity of 2 that every expert
    fills.  The program sends token 0 to expert 1 on a near-tie, so
    expert 1 drops token 3: one capacity flip at a token whose set
    agrees.  Once token 0 is settled, the reference drops token 3 too."""
    cfg = {"num_router_experts": 4, "num_experts_per_tok": 1,
           "capacity_factor": 1.0, "first_local_expert": 0,
           "n_routed_experts": 4}
    z = torch.full((8, 4), 0.1)
    for t in range(8):
        z[t, t // 2] = 0.9
    z[0, 1] = 0.9 - 1e-7
    own = torch.sort(z, dim=-1, descending=True, stable=True)[1][:, :1]
    prog = own.clone()
    prog[0, 0] = 1
    keep = ref.kept(cfg, prog).reshape(-1)
    assert keep.tolist() == [True, True, True, False] + [True] * 4
    family.ROUTED[:] = [(prog.to(torch.int16), keep)]
    ref.WITNESS.clear()
    settled = ref.settle_ties(cfg, own, z)
    assert torch.equal(settled, prog)
    assert torch.equal(ref.kept(cfg, settled).reshape(-1), keep)
    w = ref.WITNESS[0]
    assert (w["differ"], w["adopted"], w["capacity_flips"],
            w["keep_differs_after"]) == (1, 1, 1, 0)
    assert (w["held"], w["held_kept"]) == (8, 7)


def test_a_run_without_the_programs_routing_keeps_its_own():
    """No record, or none that agrees with the reference's own sets at
    three quarters of the tokens: the reference keeps its own routing."""
    cfg, z, own, prog, keep = _near_tie_case()
    family.ROUTED.clear()
    assert ref.settle_ties(cfg, own, z) is own
    other = (prog + 3) % 8
    family.ROUTED[:] = [(other.to(torch.int16), keep)]
    assert ref.settle_ties(cfg, own, z) is own


def test_mla_alone_is_the_references():
    """One latent-attention mixer, output and input gradient, over 40
    tokens (rope at 40 positions, the causal mask): within 2e-6 of the
    largest value (float32 sums in other orders; the reference's rope
    angles are float64 rounded, the port's float32)."""
    cfg, arch = _tiny(), _arch()
    tree, _, leaves = _block_params(cfg, 1)
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(3))
    xp, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, cache = attention.mla(tree["mla"], xp, arch, mode="train")
    want = ref.mla(cfg, xr, *leaves[2:len(ref.LAYER)])
    assert cache is None and got.shape == (2, 40, 64)
    assert _rel(got, want) < 2e-6
    g = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(4))
    (gp,) = torch.autograd.grad(got, xp, g)
    (gr,) = torch.autograd.grad(want, xr, g)
    assert _rel(gp, gr) < 2e-6


def test_mla_beyond_the_plain_attentions_length_is_the_same():
    """Past ``FULL_ATTN_MAX`` the CPU takes the blockwise attention: at
    T = 1100 it agrees with the plain one (v narrower than q and k)."""
    arch = dataclasses.replace(_arch(), num_layers=1)
    p = attention.init_mla_params(torch.Generator().manual_seed(0), arch)
    x = torch.randn(1, 1100, 64, generator=torch.Generator().manual_seed(1))
    chunked, _ = attention.mla(p, x, arch, mode="train")
    q, c, k_pe = attention._mla_project(p, x, arch, torch.arange(1100))
    k, v = attention._mla_keys(p, c, k_pe, arch)
    bias = attention._mask_bias(torch.arange(1100), torch.arange(1100),
                                causal=True, window=0, dtype=torch.float32)
    plain = attention._sdpa(q, k, v, bias, 1, 0.0).reshape(1, 1100, 64)
    assert _rel(chunked, torch.matmul(plain, p["wo"])) < 2e-6


def test_flash_takes_a_narrower_v_on_the_cpu():
    """The wrapper's CPU path (the kernel's plain version) at q / k 192
    and v 128, GQA 16/4: the output takes v's width, and equals the plain
    attention written out."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 33, 192, generator=gen)
    k = torch.randn(1, 4, 33, 192, generator=gen)
    v = torch.randn(1, 4, 33, 128, generator=gen)
    got = flash_ops.flash_attention(q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(4, 1)) / 192 ** 0.5
    s = s.masked_fill(torch.ones(33, 33, dtype=torch.bool).triu(1),
                      float("-inf"))
    want = torch.softmax(s, -1) @ v.repeat_interleave(4, 1)
    assert got.shape == (1, 16, 33, 128) and _rel(got, want) < 1e-6
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v[:, :, :32])


def _router_cfg(**changes):
    return dataclasses.replace(_arch(), **changes)


def test_sigmoid_routing_takes_the_bias_to_choose_and_the_scores_to_weigh():
    """A router of 8 experts, top-2, written by hand: the bias moves an
    expert into the chosen set, the weights are the unshifted scores of
    the chosen experts over their sum times the routed scaling; a tie of
    shifted scores goes to the lower expert (the stable sort)."""
    cfg = _router_cfg(capacity_factor=8.0, experts_first=0, experts_held=8)
    e = 8
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -2.0, 0.2, 0.1],
                           [0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]])
    bias = torch.tensor([0.0, 0.0, 0.3, 0.0, 0.0, 0.0, 0.0, 0.0])
    d = cfg.d_model
    x = torch.zeros(1, 2, d)
    x[0, :, :e] = logits                            # router = [I; 0]
    router = torch.zeros(d, e)
    router[:e] = torch.eye(e)
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe_params(gen, cfg)
    params.update(router=router, bias=bias)
    seen = []
    real = moe.route

    def spy(probs, c, cap):
        r = real(probs, c, cap)
        seen.append(r)
        return r
    moe.route = spy
    try:
        out, _ = moe.apply_moe(params, x, cfg)
    finally:
        moe.route = real
    (r,) = seen
    s = torch.sigmoid(logits)
    # token 0: by scores alone experts 0 and 1; the bias lifts expert 2
    # above both
    assert r.top_e[0].tolist() == [2, 0]
    # token 1: every shifted score ties except expert 2's
    assert r.top_e[1].tolist() == [2, 0]
    w0 = s[0, [2, 0]] / s[0, [2, 0]].sum() * cfg.routed_scaling
    want, _ = ref.moe(_ref_moe_cfg(cfg, 0, 8), x, router, bias,
                      params["gate"], params["up"], params["down"])
    assert _rel(out, want) < 1e-6
    y0 = sum(w0[j] * apply_mlp({k: params[k][ex] for k in
                                ("gate", "up", "down")}, x[0, 0], "silu")
             for j, ex in enumerate((2, 0)))
    assert _rel(out[0, 0], y0) < 1e-6


def _ref_moe_cfg(cfg, first, held):
    return {"num_router_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.top_k,
            "capacity_factor": cfg.capacity_factor,
            "routed_scaling_factor": cfg.routed_scaling,
            "first_local_expert": first, "n_routed_experts": held}


def test_the_router_and_its_aux_are_the_references():
    """The reduced model's MoE layer at a capacity that drops, on 2
    sequences of 21 tokens: the port's output and per-sequence aux against
    the reference; the bias changes the chosen set of some tokens."""
    cfg = _router_cfg(capacity_factor=0.5, experts_first=2, experts_held=4)
    gen = torch.Generator().manual_seed(7)
    params = moe.init_moe_params(gen, cfg)
    params["bias"] = torch.randn(8, generator=gen) * 0.05
    x = torch.randn(2, 21, cfg.d_model, generator=gen)
    out, aux = moe.apply_moe(params, x, cfg)
    want, want_aux = ref.moe(_ref_moe_cfg(cfg, 2, 4), x, params["router"],
                             params["bias"], params["gate"], params["up"],
                             params["down"])
    assert _rel(out, want) < 1e-6
    assert abs(float(aux - want_aux)) < 1e-6 * float(want_aux)
    s = torch.sigmoid(x.reshape(42, -1) @ params["router"])
    plain = torch.sort(s, dim=-1, descending=True, stable=True)[1][:, :2]
    shifted = torch.sort(s + params["bias"], dim=-1, descending=True,
                         stable=True)[1][:, :2]
    moved = (plain.sort(-1)[0] != shifted.sort(-1)[0]).any(-1)
    assert 0 < int(moved.sum()) < 42
    # per sequence: not the Switch loss of the batch as one
    whole = moe.router_load_balance_loss(s / s.sum(-1, keepdim=True),
                                         shifted, 8)
    assert abs(float(aux - whole)) > 1e-4


def test_held_experts_no_token_reaches_are_the_references():
    """A bias that sends every token to experts 0 and 1 while experts 2-5
    are held here: the port's share adds nothing, and the reference gives
    its idle experts a zero gradient instead of leaving them out of the
    graph."""
    cfg = _router_cfg(capacity_factor=8.0, experts_first=2, experts_held=4)
    gen = torch.Generator().manual_seed(2)
    params = moe.init_moe_params(gen, cfg)
    params["bias"] = torch.tensor([9.0, 9.0] + [0.0] * 6)
    x = torch.randn(1, 7, cfg.d_model, generator=gen)
    out, _ = moe.apply_moe(params, x, cfg)
    leaves = [params[k].clone().requires_grad_() for k in
              ("gate", "up", "down")]
    want, aux = ref.moe(_ref_moe_cfg(cfg, 2, 4), x, params["router"],
                        params["bias"], *leaves)
    assert float(out.abs().max()) == 0.0 and float(want.abs().max()) == 0.0
    grads = torch.autograd.grad(want.sum() + aux, leaves)
    assert all(float(g.abs().max()) == 0.0 for g in grads)


def test_the_bias_has_no_gradient():
    cfg = _router_cfg()
    gen = torch.Generator().manual_seed(1)
    params = moe.init_moe_params(gen, cfg)
    params["bias"] = (torch.randn(8, generator=gen) * 0.05).requires_grad_()
    params["router"].requires_grad_()
    out, aux = moe.apply_moe(params, torch.randn(1, 9, cfg.d_model,
                                                 generator=gen), cfg)
    g = torch.autograd.grad((out.sum() + aux), [params["router"],
                                                params["bias"]],
                            allow_unused=True)
    assert g[0] is not None and g[1] is None


def test_the_leading_dense_layer_is_the_references():
    """Block 0: latent attention and a SwiGLU of the dense width (no
    experts, no aux) against the reference's dense block."""
    cfg, arch = _tiny(), _arch()
    tree, kind, leaves = _block_params(cfg, 0)
    assert kind == "dense" and "moe" not in tree
    assert tree["mlp"]["up"].shape == (64, 96)
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(9))
    got, _, aux = blocks.apply_block(tree, x, arch, "mla", mode="train")
    want, want_aux = ref.block(cfg, "dense", x, *leaves)
    assert _rel(got, want) < 2e-6
    assert float(aux) == 0.0 and float(want_aux) == 0.0
    assert model_lib.aux_cotangent(arch, 1, torch.ones(())) is None
    assert model_lib.aux_cotangent(arch, 2, torch.ones(())) is not None


def test_four_shares_add_up_to_the_whole_layer():
    """An 8-expert sigmoid layer, top-2, a capacity that drops, cut into
    four shares of 2 experts: their outputs, with the shared experts
    counted once, add up to the uncut layer's (the port's and the
    reference's), and every share's aux is the whole router's."""
    cfg = _router_cfg(capacity_factor=0.5, experts_first=0, experts_held=8)
    gen = torch.Generator().manual_seed(0)
    whole = moe.init_moe_params(gen, cfg)
    whole["bias"] = torch.randn(8, generator=gen) * 0.05
    shared = {k: torch.randn(s, generator=gen) * 0.2 for k, s in
              (("gate", (64, 64)), ("up", (64, 64)), ("down", (64, 64)))}
    x = torch.randn(3, 11, 64, generator=gen)
    out, aux = moe.apply_moe(whole, x, cfg)
    parts = []
    for i in range(4):
        share = dataclasses.replace(cfg, experts_first=2 * i, experts_held=2)
        p = {"router": whole["router"], "bias": whole["bias"],
             **{k: whole[k][2 * i:2 * i + 2] for k in ("gate", "up", "down")}}
        y, a = moe.apply_moe(p, x, share)
        assert torch.equal(a, aux)
        parts.append(y)
    s = apply_mlp(shared, x, "silu")
    total = sum(parts) + s
    assert torch.allclose(total, out + s, rtol=0, atol=1e-6)
    want, want_aux = ref.moe(_ref_moe_cfg(cfg, 0, 8), x, whole["router"],
                             whole["bias"], whole["gate"], whole["up"],
                             whole["down"])
    assert torch.allclose(total, want + s, rtol=0, atol=1e-5)
    assert torch.allclose(aux, want_aux, rtol=1e-6)


def test_prefill_then_decode_through_the_latent_cache():
    """``batched_generate`` on the reduced model (a capacity no token
    exceeds, as a decode step's capacity is not a full forward's): the
    prefill's caches hold c and k_pe a token (16 + 8 numbers, against 4 x
    (24 + 16) decompressed), grown to the prompt plus the new tokens; every
    step's logits equal the full forward's over prompt and served tokens,
    and the reference's, within 2e-5 of their scale."""
    arch = dataclasses.replace(_arch(), capacity_factor=8.0)
    cfg = {**_tiny(), "capacity_factor": 8.0}
    drawn = weights.draw(cfg, 2 ** 31 + 3, "cpu")
    params = weights.program_params(cfg, drawn)
    prompts = torch.randint(0, 256, (2, 12),
                            generator=torch.Generator().manual_seed(5))
    steps = []

    def hook(i, logits, caches):
        if i == 0:
            assert all(isinstance(c, attention.MLACache) for c in caches)
            assert [tuple(c.c.shape) for c in caches] == [(2, 17, 16)] * 3
            assert [tuple(c.k_pe.shape) for c in caches] == [(2, 17, 8)] * 3
        steps.append(logits[:, -1].clone())
    served = decode.batched_generate(arch, params, prompts,
                                     max_new_tokens=5, on_step=hook)
    full_tokens = torch.cat([prompts, served.long()], dim=1)
    full, _, _ = model_lib.forward(arch, params, {"tokens": full_tokens})
    rp = ref.params_from_stacked(cfg, drawn)
    want = ref.head(cfg, rp, ref.hidden(cfg, rp, full_tokens)[0])
    assert len(steps) == 6
    for i, got in enumerate(steps):
        assert _rel(got, full[:, 11 + i]) < 2e-5
        assert _rel(got, want[:, 11 + i]) < 2e-5


def test_the_preset_is_the_published_model_and_a_port_architecture():
    """``ARCHITECTURES`` stays the reference package's set; ``get_config``
    finds the preset, whose cut to one rank of 8 holds the parameter
    count the configuration file states (2,777,412,736)."""
    assert set(ARCHITECTURES) == REFERENCE_SET
    cfg = get_config("moonlight-16b-a3b")
    assert cfg.layer_kinds() == ("mla",) * 27
    assert cfg.mlp_kinds() == ("dense",) + ("moe",) * 26
    assert (cfg.head_dim, cfg.q_dim, cfg.v_head_dim) == (192, 3072, 128)
    cut = dataclasses.replace(cfg, experts_held=8, vocab_size=20480)
    sizes = [b // 4 for b in model_lib.sched_layer_bytes(cut)]
    assert sizes[:3] == [41_943_040, 82_973_184, 100_405_824]
    assert sizes[-1] == 41_945_088
    assert sum(sizes) == 2_777_412_736


def test_the_benchmark_file_is_the_preset_cut_to_a_rank():
    f = json.loads((ROOT / "portbench" / "configs" /
                    "moonlight-16b-a3b.json").read_text())
    run = {**f, **f["departs"]}
    arch = family.arch_for(run)
    assert (arch.num_layers, arch.num_experts, arch.num_held_experts,
            arch.vocab_size) == (27, 64, 8, 20480)
    assert sum(torch.Size(s).numel() for s, _ in
               family.shapes(run).values()) == 2_777_412_736
    for key, value in (("kv_lora_rank", 256), ("scoring_func", "softmax"),
                       ("n_group", 8)):
        with pytest.raises(ValueError):
            family.arch_for({**run, key: value})


def test_the_analytic_costs_count_mla_and_the_dense_layer():
    """DynaComm's analytic layer costs: block 0 counts latent attention
    and the dense SwiGLU of 11,264, a MoE block the router, the held
    experts' capacity and the shared experts."""
    from repro_torch.configs import InputShape
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"),
                              experts_held=8, vocab_size=20480)
    b, t = 2, 4096
    profs = profiles.layer_profiles(cfg, InputShape("x", t, b, "train"))
    assert len(profs) == 29
    n = b * t
    mla = 2.0 * n * 2048 * (3072 + 576) + 2.0 * n * 512 * 4096 \
        + 2.0 * b * 16 * t * t * (192 + 128) + 2.0 * n * 2048 * 2048
    dense = 2.0 * n * 2048 * 11264 * 3
    assert profs[1].flops_fwd == pytest.approx(mla + dense, rel=1e-12)
    cap = moe.expert_capacity(n, cfg)
    routed = 2.0 * n * 2048 * 64 + 2.0 * 8 * cap * 2048 * 1408 * 3 \
        + 2.0 * n * 2048 * 2816 * 3
    assert profs[2].flops_fwd == pytest.approx(mla + routed, rel=1e-12)
