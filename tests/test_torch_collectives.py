"""The port's flat buffers and bucket collectives against the reference.

Flat layouts are held bitwise against ``repro.dist.collectives`` for every
sched layer; the collectives run on 2 spawned gloo ranks
(``helpers/torch_gloo_check.py``) and are held against a numpy emulation of
the reference's ``jnp.concatenate`` / ``all_gather`` / ``psum_scatter``
layout.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist import collectives as jax_coll
from repro.models import init_params as jax_init_params
from repro.models import sched_layer_trees as jax_sched_trees
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.dist import collectives as coll
from repro_torch.interop import params_from_numpy
from repro_torch.models import param_shapes, sched_layer_trees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "helpers", "torch_gloo_check.py")


def _numpy_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-2b",
                                  "recurrentgemma-2b"])
@pytest.mark.parametrize("axis", [1, 2, 3])
def test_flatten_tree_bitwise_vs_reference(arch, axis):
    params = _numpy_tree(jax_init_params(jax_get_config(arch).reduced(),
                                         jax.random.PRNGKey(0)))
    mine = sched_layer_trees(params_from_numpy(params))
    for t_ref, t in zip(jax_sched_trees(params), mine):
        spec_ref = jax_coll.make_flat_spec(t_ref, axis)
        spec = coll.make_flat_spec(t, axis)
        for field in ("shapes", "offsets", "sizes", "total", "padded",
                      "axis_size", "shard_size"):
            assert getattr(spec, field) == getattr(spec_ref, field), field
        flat = coll.flatten_tree(t, spec)
        np.testing.assert_array_equal(
            flat.numpy(), np.asarray(jax_coll.flatten_tree(t_ref, spec_ref)))
        back = coll.unflatten_tree(flat, spec)
        for (p, a), b in zip(tree.leaves_with_paths(back), tree.leaves(t)):
            assert torch.equal(a, b), p


def test_leaf_order_is_jax_tree_order():
    params = _numpy_tree(jax_init_params(
        jax_get_config("granite-3-2b").reduced(), jax.random.PRNGKey(0)))
    block = jax_sched_trees(params)[1]
    paths = [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(block)[0]]
    mine = [tuple(str(k) for k in p)
            for p, _ in tree.leaves_with_paths(params_from_numpy(block))]
    assert mine == paths
    assert mine[0] == ("attn", "wk")


def test_bucket_bytes_equal_reference():
    cfg = get_config("granite-3-2b").reduced()
    specs = [coll.make_flat_spec(t, 2)
             for t in sched_layer_trees(param_shapes(cfg))]
    shapes = jax.eval_shape(lambda k: jax_init_params(
        jax_get_config("granite-3-2b").reduced(), k), jax.random.PRNGKey(0))
    specs_ref = [jax_coll.make_flat_spec(t, 2)
                 for t in jax_sched_trees(shapes)]
    for bucket in ([0], [1, 2], [3, 2, 1, 0]):
        assert coll.bucket_bytes(specs, bucket) == \
            jax_coll.bucket_bytes(specs_ref, bucket)


@pytest.mark.parametrize("bucket,sizes", [
    ([], (1, 1)), ([0, 5], (1, 1)), ([0, 1], (1, 2))])
def test_check_bucket_raises_the_reference_errors(bucket, sizes):
    specs = [coll.make_flat_spec({"w": torch.empty(4, device="meta")}, a)
             for a in sizes]
    specs_ref = [jax_coll.make_flat_spec(
        {"w": jax.ShapeDtypeStruct((4,), np.float32)}, a) for a in sizes]
    for op in ("gather_bucket", "reduce_scatter_bucket"):
        with pytest.raises(ValueError) as mine:
            coll._check_bucket(specs, bucket, op)
        with pytest.raises(ValueError) as theirs:
            jax_coll._check_bucket(specs_ref, bucket, op)
        assert str(mine.value) == str(theirs.value)


def test_flat_spec_errors():
    with pytest.raises(ValueError, match="axis_size must be >= 1"):
        coll.make_flat_spec({"w": torch.zeros(2)}, 0)
    with pytest.raises(ValueError, match="empty pytree"):
        coll.make_flat_spec({}, 1)
    spec = coll.make_flat_spec({"w": torch.zeros(3)}, 2)
    with pytest.raises(ValueError, match="flat buffer shape"):
        coll.unflatten_tree(torch.zeros(3), spec)
    with pytest.raises(ValueError, match="leaves"):
        coll.flatten_tree({"w": torch.zeros(3), "x": torch.zeros(1)}, spec)


def _run_helper(mode, tmp_path):
    out = tmp_path / f"{mode}.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, HELPER, mode, str(out)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def test_two_rank_gloo_layout_equals_reference_emulation(tmp_path):
    sys.path.insert(0, os.path.dirname(HELPER))
    try:
        import torch_gloo_check as helper
    finally:
        sys.path.pop(0)
    got = _run_helper("collectives", tmp_path)
    world = helper.WORLD
    specs, _ = helper.specs_and_trees(world)
    shards = [[helper.layer_values("shard", r, l, s.shard_size)
               for l, s in enumerate(specs)] for r in range(world)]
    # pull: rank r's operand is jnp.concatenate(cols); the all-gather
    # stacks the operands; layer l is gathered[:, off:off + w].reshape(-1)
    for i, bucket in enumerate(helper.BUCKETS[:2]):
        ops = [np.concatenate([shards[r][l] for l in bucket])
               for r in range(world)]
        gathered = np.stack(ops)
        off = 0
        for l in bucket:
            w = specs[l].shard_size
            want = gathered[:, off:off + w].reshape(-1)
            for r in range(world):
                np.testing.assert_array_equal(got[f"r{r}_gather{i}_l{l}"],
                                              want)
            off += w
        for r in range(world):
            np.testing.assert_array_equal(got[f"r{r}_gather{i}_operand"],
                                          ops[r])
    # push: rows = flat.reshape(axis, -1); operand = concatenate(rows,
    # axis=1); psum_scatter hands rank r row r of the sum
    bucket = helper.BUCKETS[2]
    operands = []
    for r in range(world):
        rows = []
        for l in bucket:
            flat = np.zeros(specs[l].padded, np.float32)
            flat[:specs[l].total] = helper.layer_values("grad", r, l,
                                                        specs[l].total)
            rows.append(flat.reshape(world, -1))
        operands.append(np.concatenate(rows, axis=1))
        np.testing.assert_array_equal(got[f"r{r}_push_operand"],
                                      operands[r].reshape(-1))
    summed = operands[0] + operands[1]
    for r in range(world):
        off = 0
        for l in bucket:
            w = specs[l].shard_size
            np.testing.assert_array_equal(got[f"r{r}_push_l{l}"],
                                          summed[r, off:off + w])
            off += w


def test_two_rank_gloo_compressed_push_equals_reference_emulation(tmp_path):
    """Each rank round-trips its own full flat gradient (the reference's
    ``compressor.feedback_roundtrip`` under jit, zero residuals), the rows
    are laid out as in ``reduce_scatter_bucket`` and summed; the port's
    operand, pushed shards and new residuals equal that bit for bit."""
    from repro.compress import make_compressor as jax_make_compressor
    sys.path.insert(0, os.path.dirname(HELPER))
    try:
        import torch_gloo_check as helper
    finally:
        sys.path.pop(0)
    got = _run_helper("compressed", tmp_path)
    world, bucket = helper.WORLD, helper.BUCKETS[2]
    specs, _ = helper.specs_and_trees(world)
    for scheme, frac in helper.COMPRESSORS:
        comp = jax_make_compressor(scheme, topk_fraction=frac,
                                   use_kernel=False)
        roundtrip = jax.jit(comp.feedback_roundtrip)
        operands = []
        for r in range(world):
            rows = []
            for l in bucket:
                flat = np.zeros(specs[l].padded, np.float32)
                flat[:specs[l].total] = helper.layer_values(
                    "grad", r, l, specs[l].total)
                c, res = roundtrip(flat, np.zeros_like(flat))
                np.testing.assert_array_equal(
                    got[f"r{r}_{scheme}_res_l{l}"].view(np.int32),
                    np.asarray(res).view(np.int32))
                rows.append(np.asarray(c).reshape(world, -1))
            operands.append(np.concatenate(rows, axis=1))
            np.testing.assert_array_equal(
                got[f"r{r}_{scheme}_operand"].view(np.int32),
                operands[r].reshape(-1).view(np.int32))
        summed = operands[0] + operands[1]
        for r in range(world):
            off = 0
            for l in bucket:
                w = specs[l].shard_size
                np.testing.assert_array_equal(
                    got[f"r{r}_{scheme}_push_l{l}"], summed[r, off:off + w])
                off += w


def test_two_rank_gloo_zero_equals_one_rank(tmp_path):
    """zero.json on 2 gloo ranks = the same run on one rank, to fp32
    roundoff (each rank's loss and gradient cover half the batch)."""
    from repro_torch.runtime import RuntimeConfig, build_runtime
    got = _run_helper("zero", tmp_path)
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        ROOT, "examples", "runtime_configs", "zero.json")), device="cpu")
    assert rt.trainer.axis_size == 1
    losses = rt.fit(3)
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-6)
    whole = rt.trainer.global_state(rt._state)
    for l, flat in enumerate(whole["flat_params"]):
        np.testing.assert_allclose(got[f"flat{l}"][:flat.numel()],
                                   flat.numpy(), rtol=0, atol=2e-5)
    led = rt.ledger
    assert int(got["num_pulls"]) == 2 * led["num_pulls"]
    assert int(got["pull_bytes"]) == 2 * led["pull_bytes"]
