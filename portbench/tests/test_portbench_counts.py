"""The counts behind ``mfu`` and the kernel rooflines: the model FLOPs
against ``torch.utils.flop_counter.FlopCounterMode`` on the plain
reference at test sizes, the kernels' operations and bytes against
shapes worked by hand."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import bucket_pack, flash_attention, model_flops
from portbench.harness import cell as cells, weights
from portbench.reference import granite

DATA = Path(__file__).resolve().parent / "data"


def config(name):
    return cells.as_run(json.loads((DATA / f"{name}.json").read_text()))


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def full_minus_causal(cfg, b, t) -> int:
    """The reference's attention computes every (query, key) pair; the
    count keeps the causal ones: the difference for one forward."""
    return (cfg["num_hidden_layers"] * 4 * b * cfg["num_attention_heads"]
            * cfg["head_dim"] * (t * t - model_flops.causal_pairs(t)))


@pytest.mark.parametrize("name", ["granite-tiny", "granite-moe-tiny"])
def test_training_flops_are_the_references_products(name):
    cfg = config(name)
    b, t = 2, 16
    drawn = weights.draw(cfg, 2 ** 31 + 1, "cpu")
    params = granite.params_from_stacked(cfg, drawn, grad=True)
    leaves = [x for _, x in granite.leaf_items(cfg, params)]
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg["vocab_size"], (b, t), generator=g)

    def step():
        loss = granite.loss(cfg, params, toks, toks, remat=False)
        torch.autograd.grad(loss, leaves)

    kept = None
    if cfg.get("num_local_experts"):
        with torch.no_grad():
            x, _ = granite.hidden(cfg, params, toks)
        kept_all = []

        def tally(cfg_, probs):
            out = route(cfg_, probs)
            kept_all.append(out[2])
            return out
        route = granite.routing
        granite.routing = tally
        try:
            flops = counted(step)
        finally:
            granite.routing = route
        kept = float(sum(k.sum() for k in kept_all)
                     / sum(k.numel() for k in kept_all))
        assert kept < 1.0
    else:
        flops = counted(step)
    want = model_flops.train_step(cfg, b, t, kept) \
        + 3 * full_minus_causal(cfg, b, t)
    assert flops == pytest.approx(want, rel=1e-9)


def test_serving_flops_are_the_references_products():
    cfg = config("granite-tiny")
    b, t = 2, 12
    params = granite.params_from_stacked(
        cfg, weights.draw(cfg, 2 ** 31 + 2, "cpu"))
    toks = torch.randint(0, cfg["vocab_size"], (b, t))

    def prefill():
        x, _ = granite.hidden(cfg, params, toks)
        granite.head(cfg, params, x[:, -1:])

    assert counted(prefill) == pytest.approx(
        model_flops.serve_batch(cfg, b, t, 1) + full_minus_causal(cfg, b, t),
        rel=1e-9)
    L, d, h, hd = 2, 64, 4, 16
    per_token = L * (d * 64 + 2 * d * 32 + 64 * d + 3 * d * 128)
    decode = 2 * b * (per_token + 256 * d) + L * 4 * b * h * hd * (t + 1) \
        + 2 * b * (per_token + 256 * d) + L * 4 * b * h * hd * (t + 2)
    assert model_flops.serve_batch(cfg, b, t, 3) \
        - model_flops.serve_batch(cfg, b, t, 1) == decode


def test_flash_counts_at_the_main_paths_shape():
    # granite-3-2b's training call: B 2, 32 / 8 heads of 64, T 1024
    assert flash_attention.live_pairs(1024, True, 0) == 524800
    assert flash_attention.ops(2, 32, 64, 1024) == 8_598_323_200
    assert flash_attention.nbytes(2, 32, 8, 1024, 64) == 41_943_040
    call = {"b": 2, "h": 32, "hkv": 8, "t": 1024, "hd": 64,
            "causal": True, "window": 0}
    peaks = {"flops": 67e12, "bytes_per_s": 3.35e12}
    # PERF.md's row 3 bound, 0.1283 ms (operations)
    assert flash_attention.bound_s(call, peaks) == pytest.approx(
        8_598_323_200 / 67e12)


def test_flash_pairs_by_hand():
    assert flash_attention.live_pairs(5, True, 0) == 15
    assert flash_attention.live_pairs(8, True, 3) == 1 + 2 + 3 * 6
    assert flash_attention.live_pairs(4, False, 0) == 16
    assert flash_attention.live_pairs(4, True, 8) == 10


def test_bucket_copy_bytes_by_hand():
    specs = [(10, 10, 1), (6, 6, 1), (4, 4, 1)]
    plan = (((0, 1), (2,)), ((2, 1), (0,)))
    # pulls: pack 2 x 20 + unpack 2 x 20; push: read 20, write 20
    assert bucket_pack.step_bytes(specs, plan) == 4 * (80 + 40)
    assert bucket_pack.launches(plan) == 2 * 2 + 2
    # two ranks, 5 elements padded to 6: a shard of 3
    assert bucket_pack.step_bytes([(5, 6, 2)], (((0,),), ((0,),))) \
        == 4 * ((2 * 3 + 2 * 2 * 3) + (5 + 6))


def test_the_main_paths_step_flops():
    cfg = json.loads((DATA.parents[1] / "configs" /
                      "granite-3-2b.json").read_text())
    # 6 x 2.533e9 x 2048 + 1.032e12 of attention: 3.216e13
    assert model_flops.train_step(cfg, 2, 1024) == pytest.approx(
        3.2157e13, rel=1e-3)
