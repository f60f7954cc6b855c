"""The port's examples (``examples/torch_<name>.py``) against the
reference's (``examples/<name>.py``) on the CPU, at small flags.

Each pair runs in this process as ``__main__`` with the same ``sys.argv``
(the port's with ``--device cpu``).  The two host-only examples must print
the reference's text exactly; the others must print it once
``torch_examples.mask_example_text`` (``tests/helpers``) has masked the
wall-clock figures and the weight-dependent values (finite losses,
sampled token ids: the port draws its own weights), after one
translation of the reference's text
(``torch_examples.EXAMPLE_TRANSLATION``): the port has no HLO, so its plan
lines count the collectives a plan's first step launched (``coll``) where
the reference reads ``hlo``, and a pointer to another example names the
port's script.  The PS, pipeline and fleet
examples are in ``tests/test_torch_examples_ps.py``.
"""

import importlib.util
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "helpers"))
import torch_examples as te  # noqa: E402

CNNS = ("vgg19", "googlenet", "inception-v4", "resnet152")


def reference_text(name, argv=()):
    import jax
    assert len(jax.devices()) == 1, "the port's examples run at world 1"
    return te.translate_reference_text(te.run_example(
        te.example_path(name, port=False), argv))


def port_text(name, argv=()):
    return te.run_example(te.example_path(name), (*argv, "--device", "cpu"))


@pytest.fixture
def own_group():
    """Destroy the process group an example made (its gloo group)."""
    import torch.distributed as dist
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


def assert_same_masked(name, argv):
    want = te.mask_example_text(reference_text(name, argv))
    got = te.mask_example_text(port_text(name, argv))
    assert got.splitlines() == want.splitlines()
    return got


def test_quickstart_prints_the_reference_text_exactly():
    text = port_text("quickstart")
    assert text == reference_text("quickstart")
    assert "dynacomm    fwd buckets   3  bwd buckets   2" in text


@pytest.mark.parametrize("model", CNNS)
def test_paper_cnn_study_prints_the_reference_text_exactly(model):
    argv = ("--model", model)
    text = port_text("paper_cnn_study", argv)
    assert text == reference_text("paper_cnn_study", argv)
    assert text.startswith(f"{model} (batch 32): L=")


@pytest.mark.parametrize("model", CNNS)
def test_the_testbed_copy_prices_the_cnns_as_the_reference(model):
    """``torch_paper_cnn_study.cnn_costs`` (the port's copy of the edge
    testbed) gives ``benchmarks.edge_setup.cnn_costs``'s vectors."""
    import numpy as np
    from benchmarks.edge_setup import cnn_costs
    spec = importlib.util.spec_from_file_location(
        "torch_paper_cnn_study",
        os.path.join(ROOT, "examples", "torch_paper_cnn_study.py"))
    study = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(study)
    for batch, workers in ((32, 8), (8, 3)):
        got = study.cnn_costs(model, batch=batch, workers=workers)
        want = cnn_costs(model, batch=batch, workers=workers)
        assert got.num_layers == want.num_layers and got.dt == want.dt
        for field in ("pt", "gt", "fc", "bc"):
            assert np.array_equal(np.asarray(getattr(got, field)),
                                  np.asarray(getattr(want, field))), field


def test_edge_training_prints_the_reference_text(own_group):
    text = assert_same_masked("edge_training",
                              te.EXAMPLES["edge_training"])
    assert "strategy dynacomm: 1 pull buckets, 1 push buckets" in text
    assert text.endswith("done.\n")


def test_bandwidth_drift_prints_the_reference_text(own_group):
    text = assert_same_masked("bandwidth_drift",
                              te.EXAMPLES["bandwidth_drift"])
    assert "(coll 2 ag / 2 rs)" in text
    assert "WARNING: decision did not change" in text


def test_serving_prints_the_reference_text(own_group):
    text = assert_same_masked("serving", te.EXAMPLES["serving"])
    assert text.startswith("arch gemma2-2b-smoke: generated 32 tokens "
                           "(4 requests x 8)")


def test_the_mask_hides_clock_and_weight_values_only():
    line = ("  epoch   1: 2 pull / 3 push buckets (coll 2 ag / 3 rs)  "
            "RE-SEGMENTED  sched 0.75 ms hidden=True")
    assert te.mask_example_text(line) == (
        "  epoch   1: 2 pull / 3 push buckets (coll 2 ag / 3 rs)  "
        "RE-SEGMENTED  sched <ms> ms hidden=<clock>")
    assert te.mask_example_text(
        "  6 pushes, final loss 2.2436; loss 3.0828 -> 2.2436 over 8 "
        "versions") == ("  6 pushes, final loss <loss>; loss <loss> -> "
                        "<loss> over 8 versions")
    # a loss that is not finite stays, so it differs from the reference's
    for bad in ("nan", "inf", "-inf"):
        assert te.mask_example_text(f"final loss {bad}; 3.1 -> {bad} over") \
            == f"final loss {bad}; 3.1 -> {bad} over"
    assert te.printed_losses("loss 3.0828 -> 2.2436 over; loss nan") == [
        "3.0828", "2.2436"]
    kept = "ledger: 10 pulls (2.10 MB activations) / 16 pushes"
    assert te.mask_example_text(kept) == kept


def test_host_draws_leave_cpu_draws_alone():
    """``te.host_draws`` reroutes only draws from a card's generator (the
    card tests hold that path): a CPU generator's draws are unchanged
    under it, and ``torch.randn`` / ``torch.rand`` come back after."""
    saved = torch.randn, torch.rand

    def draws():
        gen = torch.Generator().manual_seed(5)
        return (torch.randn((3, 4), generator=gen),
                torch.rand(2, 3, generator=gen, dtype=torch.float64))
    want = draws()
    with te.host_draws():
        got = draws()
        assert torch.randn is not saved[0]
    assert (torch.randn, torch.rand) == saved
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_printed_losses_agree_to_their_last_digit():
    assert te.printed_losses_agree(["2.2436", "1.5"], ["2.2437", "1.5"],
                                   2e-6) <= 1.0
    for got in (["2.2438", "1.5"], ["nan", "1.5"], ["2.2436"]):
        with pytest.raises(AssertionError):
            te.printed_losses_agree(got, ["2.2436", "1.5"], 2e-6)


@pytest.mark.parametrize("name", [n for n in te.EXAMPLES
                                  if n not in te.HOST_EXAMPLES])
def test_examples_that_place_tensors_need_a_card_or_cpu(name):
    """With no ``--device``, an example runs on the card and raises
    without one: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.run_example(te.example_path(name), te.EXAMPLES[name])


@pytest.mark.parametrize("name", list(te.EXAMPLES))
def test_the_reference_texts_at_the_defaults_are_masked(name):
    """``chip_smoke.py`` holds the card's text at the defaults against
    these files (``tests/helpers/example_texts.py`` writes them): each is
    masked and translated already, and the host-only ones equal the
    reference's live text."""
    text = (te.EXAMPLE_TEXTS / f"{name}.txt").read_text()
    assert te.mask_example_text(text) == text
    assert te.translate_reference_text(text) == text
    if name in te.HOST_EXAMPLES:
        assert text == reference_text(name)
