"""The plain references against the port (``repro_torch``) at test sizes
on the CPU, from the same drawn weights: the dense and the MoE (with
capacity drops) forward, loss and gradients, AdamW, and the full forward
serving is checked with.  The test may import the port; the reference
may not (``test_portbench_hygiene.py``)."""

import json
from pathlib import Path

import pytest
import torch

from portbench.families.granite import arch_for, program_trees
from portbench.harness import cell as cells, weights
from portbench.reference import granite
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 31 + 3


def config(name):
    return cells.as_run(json.loads((DATA / f"{name}.json").read_text()))


def batch(cfg, b=2, t=16, seed=5):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg["vocab_size"], (b, t), generator=g)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}


def port_loss_and_grads(cfg, drawn, bt):
    from repro_torch import tree
    from repro_torch.models import model as model_lib
    arch = arch_for(cfg)
    params = weights.program_params(cfg, {k: v.clone()
                                          for k, v in drawn.items()})
    params = tree.tree_map(lambda x: x.requires_grad_(), params)
    loss = model_lib.train_loss(arch, params, bt,
                                aux_weight=cfg.get("router_aux_loss_coef",
                                                   0.0))
    names = [leaf for t in program_trees(cfg)
             for leaf in weights.named_leaves(t)]
    trees = model_lib.sched_layer_trees(params)
    leaves = [x for t in trees for x in tree.leaves(t)]
    grads = torch.autograd.grad(loss, leaves)
    return float(loss), dict(zip(names, grads))


def ref_loss_and_grads(cfg, drawn, bt, remat):
    params = granite.params_from_stacked(cfg, drawn, grad=True)
    items = list(granite.leaf_items(cfg, params))
    loss = granite.loss(cfg, params, bt["tokens"], bt["labels"],
                        remat=remat)
    grads = torch.autograd.grad(loss, [x for _, x in items])
    return float(loss), {leaf: g for (leaf, _), g in zip(items, grads)}


@pytest.mark.parametrize("name", ["granite-tiny", "granite-moe-tiny"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_equal_the_ports(name, remat):
    cfg = config(name)
    drawn = weights.draw(cfg, SEED, "cpu")
    bt = batch(cfg)
    want_loss, want = port_loss_and_grads(cfg, drawn, bt)
    got_loss, got = ref_loss_and_grads(cfg, drawn, bt, remat)
    assert abs(got_loss - want_loss) <= 2e-6 * abs(want_loss)
    assert set(got) == set(want)
    for leaf, g in got.items():
        scale = float(want[leaf].abs().max()) + 1e-12
        assert float((g - want[leaf]).abs().max()) <= 2e-5 * scale, leaf


def test_the_moe_reference_drops_what_the_port_drops():
    from repro_torch.models import moe as port_moe
    cfg = config("granite-moe-tiny")
    arch = arch_for(cfg)
    drawn = weights.draw(cfg, SEED, "cpu")
    x = torch.randn(2, 16, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    p = {"router": drawn["router"][0], "gate": drawn["e_gate"][0],
         "up": drawn["e_up"][0], "down": drawn["e_down"][0]}
    want, want_aux = port_moe.apply_moe(p, x, arch)
    got, got_aux = granite.moe(cfg, x, drawn["router"][0],
                               drawn["e_gate"][0], drawn["e_up"][0],
                               drawn["e_down"][0])
    probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ drawn["router"][0],
                          -1)
    _, _, kept = granite.routing(cfg, probs)
    r = port_moe.route(probs, arch, granite.capacity(cfg, 32))
    assert not bool(kept.all()), "the test size must drop assignments"
    assert torch.equal(kept.reshape(-1), r.keep)
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


def test_adamw_is_the_ports():
    """The reference's AdamW constants are the port's defaults (the
    runtime passes the learning rate alone), and its update the port's."""
    import inspect
    from repro_torch.optim import adamw
    defaults = {k: p.default for k, p in
                inspect.signature(adamw).parameters.items() if k != "lr"}
    assert defaults == {"b1": ref_train.B1, "b2": ref_train.B2,
                        "eps": ref_train.EPS, "weight_decay": 0.0}
    g = torch.Generator().manual_seed(3)
    p0 = [torch.randn(64, generator=g), torch.randn(3, 5, generator=g)]
    grads = [[torch.randn_like(x) for x in p0] for _ in range(3)]
    opt = adamw(3e-4)
    port = [x.clone().reshape(-1) for x in p0]
    state = opt.init(port)
    ref = [x.clone() for x in p0]
    m = [torch.zeros_like(x) for x in ref]
    v = [torch.zeros_like(x) for x in ref]
    for step, gs in enumerate(grads, start=1):
        opt.update([x.reshape(-1) for x in gs], state, port)
        with torch.no_grad():
            for p, gg, mi, vi in zip(ref, gs, m, v):
                b1, b2 = ref_train.B1, ref_train.B2
                mi.mul_(b1).add_(gg, alpha=1 - b1)
                vi.mul_(b2).addcmul_(gg, gg, value=1 - b2)
                p.sub_(3e-4 * (mi / (1 - b1 ** step))
                       / ((vi / (1 - b2 ** step)).sqrt() + ref_train.EPS))
    for a, b in zip(port, ref):
        assert torch.allclose(a, b.reshape(-1), atol=1e-7, rtol=1e-6)


def test_the_training_reference_reports_every_leaf():
    cfg = config("granite-tiny")
    drawn = weights.draw(cfg, SEED, "cpu")
    out = ref_train.run(cfg, drawn, [batch(cfg, seed=s) for s in (1, 2)],
                        3e-4)
    assert len(out["losses"]) == 2
    names = {leaf for t in program_trees(cfg)
             for leaf in weights.named_leaves(t)}
    assert set(out["grad_norms"]) == set(out["change_norms"]) == names
    assert all(v > 0 for v in out["change_norms"].values())


@pytest.mark.parametrize("name", ["granite-tiny", "granite-moe-tiny"])
def test_the_full_forward_is_the_ports_train_forward(name):
    from repro_torch.models import model as model_lib
    cfg = config(name)
    if cfg.get("num_local_experts"):
        cfg = dict(cfg, capacity_factor=100.0)
        cfg["program_overrides"] = dict(cfg["program_overrides"],
                                        capacity_factor=100.0)
    drawn = weights.draw(cfg, SEED, "cpu")
    toks = batch(cfg)["tokens"]
    want, _, _ = model_lib.forward(arch_for(cfg),
                                   weights.program_params(cfg, drawn),
                                   {"tokens": toks})
    got = ref_serve.logits(cfg, granite.params_from_stacked(cfg, drawn),
                           toks, 5)
    assert torch.allclose(got, want[:, 5:], atol=2e-5, rtol=1e-5)
