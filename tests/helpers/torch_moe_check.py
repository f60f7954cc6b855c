"""Subprocess helper: the ZeRO trainer on a reduced MoE at 2 ranks.

Run as ``python torch_moe_check.py {reference|port} OUTDIR CHANGES`` with
``src`` on ``PYTHONPATH``.  Both modes train reduced granite-moe-1b-a400m
with CHANGES, a JSON object of config fields (the tests pass 8 experts at
top-2 and capacity factor 0.5, so tokens drop), for 2 AdamW steps on a
seeded batch of 4 sequences, each rank routing its own 2:

* ``reference``: the JAX package's ``ZeroTrainer`` on 2 forged host
  devices from ``init_state(PRNGKey(0))``; writes OUTDIR/reference.npz
  (initial and final whole flats, losses, FlatSpec offsets, capacities);
* ``port``: the port's ``ZeroTrainer`` on 2 spawned gloo ranks from the
  reference's initial flats; rank 0 writes OUTDIR/port.npz.
"""

import json
import os
import socket
import sys

WORLD = 2
LR = 1e-3
STEPS = 2
PLAN = ((0, 1), (2, 3)), ((3,), (2, 1, 0))


def batch_arrays(vocab):
    import numpy as np
    rng = np.random.default_rng(3)
    toks = rng.integers(0, vocab, size=(4, 16)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def run_reference(outdir, changes):
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={WORLD}"
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.core import BucketPlan
    from repro.dist.zero import ZeroTrainer
    from repro.models.moe import expert_capacity
    from repro.optim import adamw
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              **changes)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    tr = ZeroTrainer(cfg=cfg, mesh=mesh, plan=BucketPlan(*PLAN),
                     optimizer=adamw(LR))
    state = tr.init_state(jax.random.PRNGKey(0))
    out = {f"init{l}": np.asarray(f)
           for l, f in enumerate(state["flat_params"])}
    toks, labels = batch_arrays(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    step = jax.jit(tr.build_train_step())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    out.update({f"flat{l}": np.asarray(f)
                for l, f in enumerate(state["flat_params"])})
    out["losses"] = np.asarray(losses)
    out["num_layers"] = np.asarray(tr.num_layers)
    out["offsets"] = np.asarray([o for s in tr.specs for o in s.offsets])
    out["local_cap"] = np.asarray(expert_capacity(toks.size // WORLD, cfg))
    out["global_cap"] = np.asarray(expert_capacity(toks.size, cfg))
    np.savez(os.path.join(outdir, "reference.npz"), **out)


def port_worker(rank, port, outdir, changes):
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import BucketPlan
    from repro_torch.dist.zero import ZeroTrainer
    from repro_torch.optim import adamw
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        cfg = dataclasses.replace(
            get_config("granite-moe-1b-a400m").reduced(), **changes)
        tr = ZeroTrainer(cfg=cfg, plan=BucketPlan(*PLAN),
                         optimizer=adamw(LR), device="cpu")
        with np.load(os.path.join(outdir, "reference.npz")) as ref:
            init = [torch.from_numpy(ref[f"init{l}"])
                    for l in range(tr.num_layers)]
        state = tr.state_from_flats(init)
        toks, labels = batch_arrays(cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(labels).long()}
        losses = []
        for _ in range(STEPS):
            state, loss = tr.step(state, batch)
            losses.append(float(loss))
        whole = tr.global_state(state)
        if rank == 0:
            out = {f"flat{l}": f.numpy()
                   for l, f in enumerate(whole["flat_params"])}
            out["losses"] = np.asarray(losses)
            out["offsets"] = np.asarray([o for s in tr.specs
                                         for o in s.offsets])
            np.savez(os.path.join(outdir, "port.npz"), **out)
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    mode, outdir, changes = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    if mode == "reference":
        run_reference(outdir, changes)
    else:
        import torch
        import torch.multiprocessing as mp
        torch.set_num_threads(1)
        mp.spawn(port_worker, args=(free_port(), outdir, changes),
                 nprocs=WORLD)
