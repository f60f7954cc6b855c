"""Subprocess helper: 2-rank gloo checks of the port's collectives and ZeRO.

Run as ``python torch_gloo_check.py {collectives|compressed|zero} OUT.npz`` with
``src`` on ``PYTHONPATH``.  Spawns two CPU ranks on a gloo group and
writes what rank 0 (and, for the collectives, each rank) saw into OUT.npz;
the parent test compares it with a numpy emulation of the reference's
``dist/collectives.py`` or with a 1-rank run.  Imports no JAX.

* ``collectives``: every rank gathers buckets of random shards and
  reduce-scatters buckets of random gradient trees (both from numpy seeds
  keyed by rank and layer) over reduced granite-3-2b's sched layers,
  recording the operand handed to each collective.
* ``compressed``: every rank pushes the same gradient bucket through
  ``compressed_reduce_scatter_bucket`` with int8 and with top-k (fraction
  0.05) compressors and zero error-feedback residuals, recording the
  operand, its pushed shards and the new residuals.
* ``zero``: ``zero.json`` through ``build_runtime(device="cpu")`` on the
  2-rank group, 3 steps; rank 0 saves the losses, the final whole flat
  parameters and the ledger.
"""

import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
BUCKETS = ([0, 1], [2], [3, 2, 1])     # reduced granite: 4 sched layers


def layer_values(kind: str, rank: int, layer: int, n: int) -> np.ndarray:
    seed = {"shard": 0, "grad": 1}[kind]
    rng = np.random.default_rng((seed, rank, layer))
    return rng.standard_normal(n).astype(np.float32)


def specs_and_trees(world: int):
    from repro_torch.configs import get_config
    from repro_torch.dist.collectives import make_flat_spec
    from repro_torch.models import param_shapes, sched_layer_trees
    trees = sched_layer_trees(param_shapes(get_config("granite-3-2b")
                                           .reduced()))
    return [make_flat_spec(t, world) for t in trees], trees


def run_collectives(rank: int, out: dict) -> None:
    from repro_torch.dist.collectives import (flatten_tree, gather_bucket,
                                              reduce_scatter_bucket)
    specs, shapes = specs_and_trees(WORLD)
    seen = []
    real_ag, real_rs = dist.all_gather_into_tensor, dist.reduce_scatter_tensor

    def ag(output, operand, **kw):
        seen.append(operand.clone())
        return real_ag(output, operand, **kw)

    def rs(output, operand, **kw):
        seen.append(operand.clone())
        return real_rs(output, operand, **kw)

    dist.all_gather_into_tensor, dist.reduce_scatter_tensor = ag, rs
    shards = [torch.from_numpy(layer_values("shard", rank, l, s.shard_size))
              for l, s in enumerate(specs)]
    for i, bucket in enumerate(BUCKETS[:2]):
        full = gather_bucket(shards, specs, bucket)
        for l in bucket:
            out[f"r{rank}_gather{i}_l{l}"] = flatten_tree(full[l],
                                                          specs[l]).numpy()
        out[f"r{rank}_gather{i}_operand"] = seen[-1].numpy()
    grads = grad_trees(rank, specs, shapes, BUCKETS[2])
    pushed = reduce_scatter_bucket(grads, specs, BUCKETS[2])
    for l in BUCKETS[2]:
        out[f"r{rank}_push_l{l}"] = pushed[l].numpy()
    out[f"r{rank}_push_operand"] = seen[-1].numpy()


def grad_trees(rank: int, specs, shapes, bucket) -> dict:
    from repro_torch import tree
    grads = {}
    for l in bucket:
        flat = layer_values("grad", rank, l, specs[l].total)
        leaves, off = [], 0
        for leaf in tree.leaves(shapes[l]):
            n = leaf.numel()
            leaves.append(torch.from_numpy(flat[off:off + n]).view(
                leaf.shape))
            off += n
        grads[l] = tree.unflatten(tree.structure(shapes[l]), leaves)
    return grads


COMPRESSORS = (("int8", None), ("topk", 0.05))


def run_compressed(rank: int, out: dict) -> None:
    from repro_torch.compress import make_compressor
    from repro_torch.dist.collectives import compressed_reduce_scatter_bucket
    specs, shapes = specs_and_trees(WORLD)
    bucket = BUCKETS[2]
    seen = []
    real_rs = dist.reduce_scatter_tensor

    def rs(output, operand, **kw):
        seen.append(operand.clone())
        return real_rs(output, operand, **kw)

    dist.reduce_scatter_tensor = rs
    for scheme, frac in COMPRESSORS:
        residuals = {l: torch.zeros(specs[l].padded) for l in bucket}
        pushed, res = compressed_reduce_scatter_bucket(
            grad_trees(rank, specs, shapes, bucket), specs, bucket, None,
            make_compressor(scheme, topk_fraction=frac), residuals)
        assert res is residuals
        for l in bucket:
            out[f"r{rank}_{scheme}_push_l{l}"] = pushed[l].numpy()
            out[f"r{rank}_{scheme}_res_l{l}"] = res[l].numpy()
        out[f"r{rank}_{scheme}_operand"] = seen[-1].numpy()


def run_zero(rank: int, out: dict) -> None:
    from repro_torch.runtime import RuntimeConfig, build_runtime
    root = os.path.join(os.path.dirname(__file__), "..", "..")
    config = RuntimeConfig.load(os.path.join(
        root, "examples", "runtime_configs", "zero.json"))
    rt = build_runtime(config, device="cpu")
    assert rt.trainer.axis_size == WORLD
    out["losses"] = np.asarray(rt.fit(3))
    whole = rt.trainer.global_state(rt._state)
    for l, flat in enumerate(whole["flat_params"]):
        out[f"flat{l}"] = flat.numpy()
    led = rt.ledger
    for k in ("pull_bytes", "push_bytes", "num_pulls", "num_pushes"):
        out[k] = np.asarray(led[k])


def worker(rank: int, mode: str, port: int, path: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    out: dict = {}
    try:
        {"collectives": run_collectives, "compressed": run_compressed,
         "zero": run_zero}[mode](rank, out)
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, out)
        if rank == 0:
            merged = {}
            for part in gathered:
                merged.update(part)
            np.savez(path, **merged)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, path = sys.argv[1], sys.argv[2]
    mp.spawn(worker, args=(mode, free_port(), path), nprocs=WORLD)
