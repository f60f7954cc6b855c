"""The port's ``TrainLoop`` against the reference's, on the CPU.

Both loops start from the reference's weights (``params_from_numpy``) and
read the same ``SyntheticText`` batches (the reference's int32 tokens, the
port's int64, equal in value).

Tolerances, each with its reason:

* losses rtol ``LOSS_RTOL``: float32 sums in another order in XLA and in
  PyTorch, carried through AdamW steps;
* parameters after the run atol ``PARAM_ATOL``: AdamW's first steps are
  nearly ``±lr`` whatever the gradient's size, so a roundoff gap in a
  near-zero gradient entry moves a weight by up to ``2·lr`` (lr 1e-3);
  the checkpoint tests compare a file with the run that wrote it, exactly;
* log lines: the reference's format (``step     N  loss X.XXXX
  (S.SSSs/step)``), the step numbers equal.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticText as JaxSyntheticText
from repro.models import model as jax_model
from repro.optim import adamw as jax_adamw
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro_torch import tree
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticText
from repro_torch.interop import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import TrainLoop
from repro_torch.train.loop import opt_tree

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-3 + 1e-5
LR = 1e-3
STEPS = 3
LOG_LINE = re.compile(r"^step +(\d+)  loss \d+\.\d{4}  \(\d+\.\d{3}s/step\)$")


def _setup():
    cfg, jcfg = get_config("granite-3-2b").reduced(), \
        jax_get_config("granite-3-2b").reduced()
    params_np = jax.tree_util.tree_map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return cfg, jcfg, params_np


def _runs(accum: int, capfd, checkpoint_path=None, jax_checkpoint_path=None):
    cfg, jcfg, params_np = _setup()
    mine = TrainLoop(cfg=cfg, optimizer=adamw(LR), accum_steps=accum,
                     log_every=1, checkpoint_path=checkpoint_path,
                     checkpoint_every=2 if checkpoint_path else 0)
    p, opt, losses = mine.run(torch.Generator(), iter(SyntheticText(
        cfg.vocab_size, 16, 4, seed=1)), STEPS,
        params=params_from_numpy(params_np))
    my_log = capfd.readouterr().out.splitlines()
    theirs = JaxTrainLoop(cfg=jcfg, optimizer=jax_adamw(LR),
                          accum_steps=accum, log_every=1,
                          checkpoint_path=jax_checkpoint_path,
                          checkpoint_every=2 if jax_checkpoint_path else 0)
    jp, jopt, jlosses = theirs.run(
        jax.random.PRNGKey(0), iter(JaxSyntheticText(jcfg.vocab_size, 16, 4,
                                                     seed=1)),
        STEPS, params=jax.tree_util.tree_map(jnp.asarray, params_np))
    their_log = capfd.readouterr().out.splitlines()
    return dict(params=p, opt=opt, losses=losses, log=my_log, jparams=jp,
                jopt=jopt, jlosses=jlosses, jlog=their_log)


@pytest.mark.parametrize("accum", [1, 4])
def test_losses_parameters_and_log_lines_match_the_reference(accum, capfd):
    r = _runs(accum, capfd)
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=LOSS_RTOL)
    for got, want in zip(tree.leaves(r["params"]),
                         jax.tree_util.tree_leaves(r["jparams"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=PARAM_ATOL)
    assert int(r["opt"].step) == int(r["jopt"].step) == STEPS
    assert len(r["log"]) == len(r["jlog"]) == STEPS
    for mine, theirs in zip(r["log"], r["jlog"]):
        m, t = LOG_LINE.match(mine), LOG_LINE.match(theirs)
        assert m and t, (mine, theirs)
        assert m.group(1) == t.group(1)


def test_checkpoints_load_across_the_two_packages(tmp_path, capfd):
    """Each loop checkpoints at step 2 of 3: the port's file loads into
    the reference's ``{"params", "opt"}`` template and the reference's
    into the port's, each holding the leaves its writer had then."""
    mine_path, theirs_path = str(tmp_path / "port.npz"), \
        str(tmp_path / "ref.npz")
    r = _runs(1, capfd, mine_path, theirs_path)
    mine_np, step = jax_load_checkpoint(
        mine_path, {"params": r["jparams"], "opt": r["jopt"]})
    assert step == 2
    theirs, step2 = load_checkpoint(
        theirs_path, {"params": r["params"],
                      "opt": opt_tree(r["opt"], r["params"])})
    assert step2 == 2
    # the same keys, shapes and dtypes in both files
    with np.load(mine_path) as a, np.load(theirs_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    # step 2 of each run: near each other (the parity tolerance) ...
    for x, y in zip(jax.tree_util.tree_leaves(mine_np),
                    tree.leaves(theirs)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0,
                                   atol=PARAM_ATOL)
    # ... and the port's file is the port's run, replayed to step 2
    cfg, _, params_np = _setup()
    p, opt, _ = TrainLoop(cfg=cfg, optimizer=adamw(LR), log_every=0).run(
        torch.Generator(), iter(SyntheticText(cfg.vocab_size, 16, 4,
                                              seed=1)), 2,
        params=params_from_numpy(params_np))
    for x, y in zip(jax.tree_util.tree_leaves(mine_np),
                    tree.leaves({"params": p, "opt": opt_tree(opt, p)})):
        np.testing.assert_array_equal(np.asarray(x), y.detach().numpy())


def test_loss_descends_small_transformer():
    """The reference's ``TestTrainLoop`` case: 20 AdamW steps of the
    reduced granite-3-2b, weights drawn by the port from a seed."""
    cfg = get_config("granite-3-2b").reduced()
    pipe = SyntheticText(cfg.vocab_size, 32, 8, seed=0)
    loop = TrainLoop(cfg=cfg, optimizer=adamw(1e-3), log_every=0)
    _, _, losses = loop.run(torch.Generator().manual_seed(0), iter(pipe),
                            num_steps=20)
    assert losses[-1] < losses[0]


def test_jax_checkpoint_of_a_reference_loop_restores_into_the_port(tmp_path):
    """A reference checkpoint written by ``save_checkpoint`` of its
    ``{"params", "opt"}`` tree loads into the port's template exactly."""
    cfg, jcfg, params_np = _setup()
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jopt = jax_adamw(LR).init(jparams)
    path = str(tmp_path / "ref.npz")
    jax_save_checkpoint(path, {"params": jparams, "opt": jopt}, step=7)
    params = params_from_numpy(params_np)
    opt = adamw(LR).init(tree.leaves(params))
    loaded, step = load_checkpoint(path, {"params": params,
                                          "opt": opt_tree(opt, params)})
    assert step == 7
    for x, y in zip(tree.leaves(loaded),
                    jax.tree_util.tree_leaves({"params": jparams,
                                               "opt": jopt})):
        np.testing.assert_array_equal(x, np.asarray(y))
