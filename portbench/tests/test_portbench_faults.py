"""The check fails what it must, at test sizes on the CPU.

Whole runs (the harness's look for a card skipped) with the timed path
broken underneath must end with ``correct`` false, once for each fault a
cell can have: a step that returns its state unchanged, half of the
batch left out with the mean over the rest, the exchange left out, a
served token altered where it is produced.  And the control, the
reference put in the program's place at the precision below float32
(TF32; emulated here, where the CPU has none), fails the cells' limits.
The control at the cells' own sizes runs on the card:
``portbench/control.py``.
"""

import pytest
import torch

from portbench import control
from portbench.harness import cell as cells
from portbench.tests import helpers

TRAIN_CELLS = ["granite-3-2b.zero", "granite-moe-1b-a400m.zero",
               "granite-3-2b.dynamic-measured"]


@pytest.fixture
def tiny(tmp_path):
    return helpers.tiny_root(tmp_path)


@pytest.mark.parametrize("workload", TRAIN_CELLS + [
    "granite-3-2b.serve-decode"])
def test_a_sound_run_is_correct(tiny, workload):
    line, _ = helpers.run(*tiny, workload)
    assert line["correct"] is True, line["checks"]


def unchanged_step(monkeypatch):
    from repro_torch.dist import zero
    step = zero.ZeroTrainer.step

    def same_state(self, state, batch):
        saved = [[x.clone() for x in state["flat_params"]],
                 [x.clone() for x in state["opt"].mu],
                 [x.clone() for x in state["opt"].nu]]
        state, loss = step(self, state, batch)
        for now, was in zip((state["flat_params"], state["opt"].mu,
                             state["opt"].nu), saved):
            for a, b in zip(now, was):
                a.copy_(b)
        return state, loss
    monkeypatch.setattr(zero.ZeroTrainer, "step", same_state)


def half_batch(monkeypatch):
    from repro_torch.dist import zero
    local = zero.ZeroTrainer._local_batch

    def first_half(self, batch):
        out = local(self, batch)
        return {k: v[:v.shape[0] // 2] for k, v in out.items()}
    monkeypatch.setattr(zero.ZeroTrainer, "_local_batch", first_half)


def no_exchange(monkeypatch):
    from repro_torch.dist import zero
    push = zero.reduce_scatter_bucket

    def nothing_arrives(grads, specs, bucket, group):
        return {l: torch.zeros_like(g)
                for l, g in push(grads, specs, bucket, group).items()}
    monkeypatch.setattr(zero, "reduce_scatter_bucket", nothing_arrives)


@pytest.mark.parametrize("fault", [unchanged_step, half_batch, no_exchange],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", TRAIN_CELLS)
def test_a_broken_training_step_is_not_correct(tiny, monkeypatch, workload,
                                               fault):
    fault(monkeypatch)
    line, _ = helpers.run(*tiny, workload)
    assert line["correct"] is False, line["checks"]


def test_an_altered_served_token_is_not_correct(tiny, monkeypatch):
    from repro_torch.serve import decode
    generate = decode.batched_generate

    def altered(cfg, params, prompts, **kw):
        out = generate(cfg, params, prompts, **kw).clone()
        if out.shape[1] > 2:
            out[:, 2] = (out[:, 2] + 1) % cfg.vocab_size
        return out
    monkeypatch.setattr(decode, "batched_generate", altered)
    line, _ = helpers.run(*tiny, "granite-3-2b.serve-decode")
    assert line["correct"] is False, line["checks"]


# The MoE cell's control is read at its own experts, top-k, capacity and
# tokens a step (its failures come from routing near-ties that TF32
# decides otherwise; at the default test size there are too few)
CONTROL_SIZES = {"granite-moe-1b-a400m.zero": {
    "granite-moe-1b-a400m": "granite-moe-control", "zero": {"seq": 1024}}}


def control_fails(tmp_path, workload, device, full_size=False):
    if full_size:
        cell = cells.resolve(cells.load_benchmark(), workload)
    else:
        bench, root = helpers.tiny_root(tmp_path, CONTROL_SIZES.get(workload))
        cell = cells.resolve(bench, workload, root)
    fails = []
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        numbers = control.readings(cell, seed, "tf32", device)
        fails.append(any(numbers[k] > v for k, v in cell.limits.items()))
    return fails


@pytest.mark.parametrize("workload", TRAIN_CELLS + [
    "granite-3-2b.serve-decode"])
def test_the_control_fails_the_cells_limits(tmp_path, workload):
    assert all(control_fails(tmp_path, workload, torch.device("cpu")))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", TRAIN_CELLS + [
    "granite-3-2b.serve-decode"])
def test_the_control_fails_the_cells_limits_on_the_card(tmp_path, workload):
    """The control with the card's own TF32, at test size; the MoE cell's
    at its own size, which the card holds (at the test size the card's
    TF32 decides too few routing near-ties the other way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness import env
    env.strict_float32()
    full = workload == "granite-moe-1b-a400m.zero"
    assert all(control_fails(tmp_path, workload, torch.device("cuda"),
                             full_size=full))
