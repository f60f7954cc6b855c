"""The port's sharding rules (``repro_torch.dist.sharding``) and meshes
against the reference's, on the CPU.

Every arch of ``configs/`` at full width: the reference's shapes come from
``jax.eval_shape`` and its rules run over a ``jax.sharding.AbstractMesh``
(no devices); the port's shapes are ``meta`` tensors.  Every comparison
is exact: the rules are integer arithmetic on shapes and paths.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import get_config as jax_get_config
from repro.dist import sharding as jax_sharding
from repro.launch import specs as jax_specs
from repro.models import scanned as jax_scanned
from repro.optim import adamw as jax_adamw
from repro_torch import tree
from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro_torch.dist import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import scanned
from repro_torch.optim import adamw
from repro_torch.train.loop import opt_tree

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
# (params, optimizer state) bytes on one device of 16 x 16, stacked layout
# in bf16, fp32 AdamW moments: the reference rules' reckoning
STATE_BYTES = {"grok-1-314b": (2_466_743_040, 9_866_972_164),
               "llava-next-34b": (265_181_056, 1_060_724_228)}


def _jax_mesh(multi_pod):
    sizes, names = MESHES[multi_pod]
    return AbstractMesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _jax_state(name, stacked):
    cfg = jax_get_config(name)
    if stacked:
        params = jax.eval_shape(
            lambda k: jax_scanned.init_stacked(cfg, k, jnp.bfloat16),
            jax.random.PRNGKey(0))
    else:
        params, _ = jax_specs.state_specs(cfg, jax_adamw(1e-4))
    return params, jax.eval_shape(jax_adamw(1e-4).init, params)


def _port_state(name, stacked):
    cfg = get_config(name)
    if stacked:
        params = scanned.init_stacked(cfg, None, torch.bfloat16, "meta")
        return params, opt_tree(adamw(1e-4).init(tree.leaves(params)),
                                params)
    return specs.state_specs(cfg, adamw(1e-4))


def _jax_specs(shardings):
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return [(jax_sharding.path_str(p), tuple(s.spec)) for p, s in flat]


def _port_specs(t, spec_tree):
    paths = [sharding.path_str(p) for p, _ in tree.leaves_with_paths(t)]
    return list(zip(paths, tree.leaves(spec_tree)))


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["per-layer", "stacked"])
@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_parameter_and_optimizer_specs_equal_the_reference(name, stacked):
    assert sorted(ARCHITECTURES) == sorted(JAX_ARCHITECTURES)
    jparams, jopt = _jax_state(name, stacked)
    params, opt = _port_state(name, stacked)
    cfg = get_config(name)
    checked = 0
    for multi_pod in (False, True):
        mesh = (mesh_lib.make_production_mesh(multi_pod=multi_pod))
        jmesh = _jax_mesh(multi_pod)
        for fsdp in (True, False):
            for moe_ep in ((False, True) if cfg.is_moe else (False,)):
                for mine, theirs in ((params, jparams), (opt, jopt)):
                    got = _port_specs(mine, sharding.params_shardings(
                        cfg, mine, mesh, fsdp=fsdp, moe_ep=moe_ep))
                    want = _jax_specs(jax_sharding.params_shardings(
                        jax_get_config(name), theirs, jmesh, fsdp=fsdp,
                        moe_ep=moe_ep))
                    assert [p for p, _ in got] == [p for p, _ in want]
                    assert got == want
                    checked += len(got)
    assert checked > 0


@pytest.mark.parametrize("name", sorted(ARCHITECTURES))
def test_batch_and_cache_specs_equal_the_reference(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    for multi_pod in (False, True):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        jmesh = _jax_mesh(multi_pod)
        for shape_name, shape in INPUT_SHAPES.items():
            jshape = JAX_INPUT_SHAPES[shape_name]
            if shape.mode == "decode":
                if cfg.encoder_only:
                    continue
                token, caches = specs.decode_specs(cfg, shape)
                jtoken, jcaches = jax_specs.decode_specs(jcfg, jshape)
                assert tuple(token.shape) == jtoken.shape
                assert sharding.batch_shardings({"t": token}, mesh)["t"] \
                    == tuple(jax_sharding.batch_shardings(
                        {"t": jtoken}, jmesh)["t"].spec)
                for seq_over_model in (False, True):
                    got = _port_specs(caches, sharding.cache_shardings(
                        caches, mesh, batch=shape.global_batch,
                        seq_over_model=seq_over_model))
                    want = _jax_specs(jax_sharding.cache_shardings(
                        jcaches, jmesh, batch=jshape.global_batch,
                        seq_over_model=seq_over_model))
                    assert [s for _, s in got] == [s for _, s in want]
                    shapes = [tuple(x.shape) for x in tree.leaves(caches)]
                    assert shapes == [x.shape for x in
                                      jax.tree_util.tree_leaves(jcaches)]
            else:
                batch = specs.input_specs(cfg, shape)
                jbatch = jax_specs.input_specs(jcfg, jshape)
                assert sorted(batch) == sorted(jbatch)
                got = sharding.batch_shardings(batch, mesh)
                want = jax_sharding.batch_shardings(jbatch, jmesh)
                for k in batch:
                    assert tuple(batch[k].shape) == jbatch[k].shape
                    assert got[k] == tuple(want[k].spec), k


@pytest.mark.parametrize("name", sorted(STATE_BYTES))
def test_per_device_state_bytes_equal_the_reckoning(name):
    """The port's ``device_bytes`` against the table, and the table
    against the reference's own specs reckoned here with numpy."""
    params, opt = _port_state(name, True)
    mesh = mesh_lib.make_production_mesh()
    cfg = get_config(name)
    got = tuple(sharding.device_bytes(t, sharding.params_shardings(
        cfg, t, mesh), mesh) for t in (params, opt))
    assert got == STATE_BYTES[name]
    jmesh = _jax_mesh(False)

    def reckon(t):
        total = 0
        shardings = jax.tree_util.tree_leaves(jax_sharding.params_shardings(
            jax_get_config(name), t, jmesh))
        for leaf, s in zip(jax.tree_util.tree_leaves(t), shardings):
            ways = [int(np.prod([jmesh.shape[a] for a in
                                 ((e,) if isinstance(e, str) else e)]))
                    if e is not None else 1
                    for e in tuple(s.spec) + (None,) * (leaf.ndim
                                                       - len(s.spec))]
            total += int(np.prod([d // w for d, w in zip(leaf.shape, ways)]
                                 )) * leaf.dtype.itemsize
        return total
    assert tuple(reckon(t) for t in _jax_state(name, True)) \
        == STATE_BYTES[name]


def test_param_pspec_cases_of_the_reference():
    """``tests/test_dist.py``'s rule cases."""
    kw = dict(model_axis="model", data_axes=("data",), model_size=16,
              data_size=16)
    assert sharding.param_pspec("layers/0/mlp/up", (2048, 8192), **kw) \
        == ("data", "model")
    assert sharding.param_pspec("layers/0/attn/wo", (4096, 2048), **kw) \
        == ("model", "data")
    assert sharding.param_pspec("layers/0/norm1", (17,), **kw) == (None,)
    assert sharding.param_pspec("stack/0/mlp/up", (40, 2048, 8192),
                                dim_offset=1, **kw) \
        == (None, "data", "model")
    assert sharding.param_pspec("layers/0/attn/wk", (2048, 8), **kw) \
        == ("data", None)
    ep = sharding.param_pspec("layers/0/moe/up", (16, 2048, 8192),
                              moe_ep=True, **kw)
    assert ep == ("model", "data", None) == tuple(jax_sharding.param_pspec(
        "layers/0/moe/up", (16, 2048, 8192), moe_ep=True, **kw))
    pod = sharding.param_pspec("x/up", (64, 32), model_axis="model",
                               data_axes=("pod", "data"), model_size=16,
                               data_size=32)
    assert pod == (("pod", "data"), "model")


def test_meshes_and_shard_shapes():
    prod, pods = mesh_lib.make_production_mesh(), \
        mesh_lib.make_production_mesh(multi_pod=True)
    assert (prod.axis_names, prod.shape, prod.size) == \
        (("data", "model"), {"data": 16, "model": 16}, 256)
    assert (pods.axis_names, pods.size) == (("pod", "data", "model"), 512)
    zero, zero2 = mesh_lib.make_zero_mesh(), \
        mesh_lib.make_zero_mesh(multi_pod=True)
    assert (zero.shape, zero2.shape) == ({"data": 256},
                                         {"pod": 2, "data": 256})
    assert mesh_lib.make_host_mesh().shape == {"data": 1}   # no group here
    assert mesh_lib.make_host_mesh(4).shape == {"data": 4}
    spec = sharding.PartitionSpec(("pod", "data"), None, "model")
    assert sharding.shard_shape((64, 3, 32), spec, pods) == (2, 3, 2)
    with pytest.raises(ValueError):
        sharding.shard_shape((10, 3, 32), spec, pods)
    assert repr(spec) == "PartitionSpec(('pod', 'data'), None, 'model')"
