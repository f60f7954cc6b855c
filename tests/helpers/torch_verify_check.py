"""Subprocess helper: the port's verification layer at 2 gloo ranks.

Run as ``python torch_verify_check.py OUT.json`` with ``src`` on
``PYTHONPATH``.  Imports no JAX.  Two runs, each over 2 CPU ranks on a
gloo group:

* ``configs``: ``zero.json``, ``ps.json``, ``dynamic.json`` and
  ``dynamic_ps.json`` through ``repro_torch.analysis.cli.verify_on_ranks``
  (the CLI's ``--device cpu --devices 2`` path, its ranks spawned once for
  the four), each rank recording its own trace;
* ``ranks``: every rank pulls and pushes the buckets of a plan over
  layers of odd sizes (each ``FlatSpec`` padded by one element at A = 2,
  which reduced granite-3-2b's even layers never are) under
  ``record_collectives``, then verifies the trace against the plan, and
  against the same specs with the padding taken away (which must fail);
  then it records one ``zero.json`` step (the loss's scalar all-reduce
  runs at A = 2 only).

Rank 0 writes what the parent test compares into OUT.json.
"""

import json
import os
import socket
import sys
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CONFIGS = ("zero", "ps", "dynamic", "dynamic_ps")
SIZES = ((3, 5), (5, 5), (7, 5), (1, 9))     # 15, 25, 35, 9 elements
FORWARD = ((0, 1), (2, 3))
BACKWARD = ((3, 2), (1,), (0,))


def run_ranks(rank: int) -> dict:
    from repro_torch.analysis import record_collectives, verify_schedule
    from repro_torch.core import BucketPlan
    from repro_torch.dist.collectives import (gather_bucket, make_flat_spec,
                                              reduce_scatter_bucket)
    from repro_torch.runtime import RuntimeConfig, build_runtime
    specs = [make_flat_spec({"w": torch.empty(s)}, WORLD) for s in SIZES]
    plan = BucketPlan(forward=FORWARD, backward=BACKWARD)
    rng = np.random.default_rng(rank)
    shards = [torch.from_numpy(rng.standard_normal(s.shard_size)
                               .astype(np.float32)) for s in specs]
    grads = {l: {"w": torch.from_numpy(rng.standard_normal(SIZES[l])
                                       .astype(np.float32))}
             for l in range(len(SIZES))}
    with record_collectives() as trace:
        for bucket in plan.forward:
            gather_bucket(shards, specs, bucket)
        for bucket in plan.backward:
            reduce_scatter_bucket(grads, specs, bucket)
    unpadded = [SimpleNamespace(total=s.total, padded=s.total,
                                axis_size=WORLD) for s in specs]
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        ROOT, "examples", "runtime_configs", "zero.json")), device="cpu")
    with record_collectives() as step:
        rt.fit(1)
    return {"totals": [s.total for s in specs],
            "padded": [s.padded for s in specs],
            "records": [[r.kind, r.bytes, r.dtype, r.group_size]
                        for r in trace],
            "findings": [f.to_dict()
                         for f in verify_schedule(trace, plan, specs)],
            "unpadded_codes": sorted({f.code for f in verify_schedule(
                trace, plan, unpadded)}),
            "zero_step": [[r.kind, r.bytes] for r in step]}


def worker(rank: int, port: int, path: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        out = run_ranks(rank)
        every = [None] * WORLD
        dist.all_gather_object(every, out)
        if rank == 0:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(every, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    from repro_torch.analysis.cli import verify_on_ranks
    torch.set_num_threads(1)
    out_path = sys.argv[1]
    paths = [os.path.join(ROOT, "examples", "runtime_configs", f"{c}.json")
             for c in CONFIGS]
    results = verify_on_ranks(paths, WORLD)
    ranks_path = out_path + ".ranks"
    mp.spawn(worker, args=(free_port(), ranks_path), nprocs=WORLD)
    with open(ranks_path, encoding="utf-8") as f:
        ranks = json.load(f)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"configs": {c: {"findings": [x.to_dict() for x in fs],
                                   "info": info}
                               for c, (fs, info) in zip(CONFIGS, results)},
                   "ranks": ranks}, f)
