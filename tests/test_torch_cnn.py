"""The paper's CNN workload in the port (``repro_torch.models.cnn``,
``repro_torch.data.pipeline``) against the reference's, on the CPU.

Exact: the four ``PAPER_CNNS`` layer tables (copied verbatim) value for
value at several batch sizes, ``SyntheticCIFAR`` batches (images bitwise,
labels by value), the text ``batch_for`` / ``make_pipeline`` streams.

To fp32 tolerance, from weights drawn by the reference and carried across
as numpy: the small CNN's logits (atol 2e-6; measured on the CPU at batch
16 over three seeds: 5.4e-7), loss (rtol 2e-6; measured 1.1e-7) and
gradients (atol 1e-6; measured 1.1e-7 against gradients up to 0.37).  A
variant that flattens the conv stack in NCHW order instead of the
reference's NHWC misses the logits by orders of magnitude more than the
tolerance, so the check sees that fault.

The paper's Fig. 10 claim, torch against torch: the CNN trained through
the PS server under the sequential plan and under a segmented DynaComm
plan gives bitwise equal losses.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxInputShape
from repro.data.pipeline import SyntheticCIFAR as JaxSyntheticCIFAR
from repro.data.pipeline import batch_for as jax_batch_for
from repro.data.pipeline import make_pipeline as jax_make_pipeline
from repro.models import cnn as jax_cnn
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import (SyntheticCIFAR, SyntheticText, batch_for,
                              make_pipeline)
from repro_torch.interop import params_from_numpy
from repro_torch.models import cnn

LOGITS_ATOL = 2e-6
LOSS_RTOL = 2e-6
GRAD_ATOL = 1e-6


def _profile_tuple(p):
    return (p.name, p.param_bytes, p.flops_fwd, p.flops_bwd, p.grad_bytes)


@pytest.mark.parametrize("name", sorted(jax_cnn.PAPER_CNNS))
@pytest.mark.parametrize("batch", [1, 32, 256])
def test_paper_cnn_tables_equal_the_reference(name, batch):
    mine = cnn.PAPER_CNNS[name](batch)
    theirs = jax_cnn.PAPER_CNNS[name](batch)
    assert [_profile_tuple(p) for p in mine] == \
        [_profile_tuple(p) for p in theirs]
    assert sorted(cnn.PAPER_CNNS) == sorted(jax_cnn.PAPER_CNNS)


def test_paper_cnn_table_helpers_equal_the_reference():
    assert _profile_tuple(cnn._conv("c", 3, 64, 7, 224, stride=2)[0]) == \
        _profile_tuple(jax_cnn._conv("c", 3, 64, 7, 224, stride=2)[0])
    assert _profile_tuple(cnn._fc("f", 4096, 1000)) == \
        _profile_tuple(jax_cnn._fc("f", 4096, 1000))
    mine, theirs = (m._bottleneck("b", 256, 128, 56, 2)
                    for m in (cnn, jax_cnn))
    assert (_profile_tuple(mine[0]), mine[1:]) == \
        (_profile_tuple(theirs[0]), theirs[1:])
    assert _profile_tuple(cnn._module("m", 10, 20.0)) == \
        _profile_tuple(jax_cnn._module("m", 10, 20.0))


@pytest.mark.parametrize("seed,step,batch,classes",
                         [(0, 0, 8, 10), (3, 17, 32, 10), (1, 2, 5, 100)])
def test_synthetic_cifar_equals_the_reference(seed, step, batch, classes):
    mine = SyntheticCIFAR(batch, classes, seed).batch(step)
    theirs = JaxSyntheticCIFAR(batch, classes, seed).batch(step)
    assert mine["images"].dtype == torch.float32
    assert mine["labels"].dtype == torch.int64
    assert tuple(mine["images"].shape) == (batch, 32, 32, 3)
    np.testing.assert_array_equal(mine["images"].numpy(),
                                  np.asarray(theirs["images"]))
    np.testing.assert_array_equal(mine["labels"].numpy(),
                                  np.asarray(theirs["labels"]))
    first = next(iter(SyntheticCIFAR(batch, classes, seed)))
    np.testing.assert_array_equal(
        first["images"].numpy(),
        np.asarray(JaxSyntheticCIFAR(batch, classes, seed).batch(0)["images"]))


def test_batch_for_and_make_pipeline_equal_the_reference():
    shape, jshape = (InputShape("t", 16, 4, "train"),
                     JaxInputShape("t", 16, 4, "train"))
    cfg, jcfg = (get_config("granite-3-2b").reduced(),
                 jax_get_config("granite-3-2b").reduced())
    for step in (0, 5):
        mine = batch_for(cfg, shape, step=step, seed=2)
        theirs = jax_batch_for(jcfg, jshape, step=step, seed=2)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(mine[key].numpy(),
                                          np.asarray(theirs[key]))
    pipe = make_pipeline(cfg, shape, seed=2)
    assert isinstance(pipe, SyntheticText)
    np.testing.assert_array_equal(
        pipe.batch(3)["tokens"].numpy(),
        np.asarray(jax_make_pipeline(jcfg, jshape, seed=2).batch(3)["tokens"]))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-34b"])
def test_batch_for_other_frontends_raise(arch):
    """The streaming pipeline raises for the stub modalities, as the
    reference's; ``batch_for`` gives their batches, with the reference's
    keys and shapes (``tests/test_torch_frontend.py`` holds the values)."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    with pytest.raises(ValueError, match="text archs"):
        make_pipeline(cfg, InputShape("t", 16, 2, "train"))
    mine = batch_for(cfg, InputShape("t", 16, 2, "train"))
    theirs = jax_batch_for(jcfg, JaxInputShape("t", 16, 2, "train"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in theirs.items()}


def _carried(seed, classes=10):
    ref = jax_cnn.small_cnn_init(jax.random.PRNGKey(seed), classes)
    return ref, params_from_numpy(jax.tree_util.tree_map(np.asarray, ref))


def _leaves(params):
    return [x for layer in params["layers"] for x in (layer["b"], layer["w"])]


def test_init_has_the_reference_tree_and_scales():
    ref, _ = _carried(0)
    mine = cnn.small_cnn_init(torch.Generator().manual_seed(0))
    assert [{k: tuple(v.shape) for k, v in layer.items()}
            for layer in mine["layers"]] == \
        [{k: tuple(v.shape) for k, v in layer.items()}
         for layer in ref["layers"]]
    assert all(x.dtype == torch.float32 for x in _leaves(mine))
    # He-normal convolutions, fc over 45 and 16: the reference's scales
    for i, scale in enumerate((1 / np.sqrt(27), 1 / np.sqrt(288),
                               1 / np.sqrt(576), 1 / 45.0)):
        std = float(mine["layers"][i]["w"].std())
        assert abs(std / scale - 1) < 0.1, (i, std, scale)
    assert all(float(layer["b"].abs().max()) == 0.0
               for layer in mine["layers"])
    again = cnn.small_cnn_init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(mine),
                                                 _leaves(again)))


@pytest.mark.parametrize("seed,batch,classes", [(0, 16, 10), (1, 16, 10),
                                                (2, 5, 7)])
def test_forward_loss_and_gradients_match_the_reference(seed, batch, classes):
    ref, mine = _carried(seed, classes)
    data = JaxSyntheticCIFAR(batch, classes, seed).batch(seed)
    images = torch.from_numpy(np.array(data["images"]))
    labels = torch.from_numpy(np.array(data["labels"]))
    np.testing.assert_allclose(
        cnn.small_cnn_forward(mine, images).numpy(),
        np.asarray(jax_cnn.small_cnn_forward(ref, data["images"])),
        rtol=0, atol=LOGITS_ATOL)
    want, grads = jax.value_and_grad(jax_cnn.small_cnn_loss)(
        ref, data["images"], data["labels"])
    leaves = [x.requires_grad_() for x in _leaves(mine)]
    loss = cnn.small_cnn_loss(mine, images, labels)
    got = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    for a, b in zip(got, [np.asarray(x) for layer in grads["layers"]
                          for x in (layer["b"], layer["w"])]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_ATOL)


def _forward_flattening_nchw(params, images):
    """The fault the port guards against: the conv stack flattened in
    NCHW, (C, H, W) order, where the reference's fc expects (H, W, C)."""
    x = images.permute(0, 3, 1, 2)
    for i in range(3):
        p = params["layers"][i]
        x = F.max_pool2d(torch.relu(cnn._conv2d(x, p["w"], p["b"])), 2, 2)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["layers"][3]["w"] + params["layers"][3]["b"])
    return x @ params["layers"][4]["w"] + params["layers"][4]["b"]


def test_nchw_flatten_order_is_caught():
    ref, mine = _carried(0)
    data = JaxSyntheticCIFAR(16, 10, 0).batch(0)
    images = torch.from_numpy(np.array(data["images"]))
    want = np.asarray(jax_cnn.small_cnn_forward(ref, data["images"]))
    wrong = _forward_flattening_nchw(mine, images).numpy()
    assert np.max(np.abs(wrong - want)) > 1e3 * LOGITS_ATOL
    right = cnn.small_cnn_forward(mine, images).numpy()
    assert np.max(np.abs(right - want)) <= LOGITS_ATOL


def test_same_padding_and_pool_shapes():
    _, mine = _carried(0)
    x = torch.zeros(2, 32, 32, 3)
    assert tuple(cnn.small_cnn_forward(mine, x).shape) == (2, 10)
    y = cnn._conv2d(x.permute(0, 3, 1, 2), mine["layers"][0]["w"],
                    mine["layers"][0]["b"])
    assert tuple(y.shape) == (2, 32, 32, 32)          # "SAME" at 3x3


def _fig10_losses(plan_of, pushes=6):
    """The CNN trained through the PS server (one worker, k = 0) under the
    plan ``plan_of(trainer)`` picks: its losses and the plan."""
    from repro_torch.optim import sgd
    from repro_torch.ps import AsyncPSTrainer, PSTopology, asymmetric_link
    _, mine = _carried(0)
    pipe = SyntheticCIFAR(32, seed=0)
    topo = PSTopology(num_servers=1, links=(asymmetric_link(1e9, 1e8),),
                      worker_flops=(1e9,))
    tr = AsyncPSTrainer(
        init_layers=mine["layers"],
        loss_fn=lambda ls, b: cnn.small_cnn_loss({"layers": ls}, b["images"],
                                                 b["labels"]),
        optimizer=sgd(0.05), topology=topo, plan=plan_of(None), staleness=0)
    tr.set_plans(plan_of(tr))
    return tr.run(pushes, lambda w, i: pipe.batch(i)).losses, tr.plan


def test_fig10_losses_bitwise_across_plans():
    from repro_torch.core import plan_from_decision, schedule
    from repro_torch.ps import PSTopology, asymmetric_link
    from repro_torch.ps.dynamic import profiles_from_specs
    from repro_torch.runtime.replan import sequential_plan

    def dynacomm(tr):
        if tr is None:
            return sequential_plan(5)
        topo = PSTopology(num_servers=1,
                          links=(asymmetric_link(1e9, 1e8),),
                          worker_flops=(1e9,))
        costs = topo.topology_costs(profiles_from_specs(
            tr.specs, flops_per_param=1000.0)).workers[0]
        return plan_from_decision(*schedule(costs, "dynacomm"), 5)

    seq, seq_plan = _fig10_losses(lambda tr: sequential_plan(5))
    dyn, dyn_plan = _fig10_losses(dynacomm)
    assert len(dyn_plan.forward) + len(dyn_plan.backward) > 2, dyn_plan
    assert dyn == seq
    assert all(np.isfinite(seq)) and seq[-1] < seq[0]
