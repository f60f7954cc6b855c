"""Production-scale dry run of every (arch x shape x mesh) combination.

The reference lowers and compiles each combination for 256 or 512 forged
devices and reads XLA's partitioned program.  The port has no compiler
and runs no step model-parallel, so it checks the same combinations on
**fake tensors** (``launch/fake.py``: shapes and dtypes, no storage, no
card, no process group, no environment flag) at the per-device
micro-batch, once each, under ``torch.utils.flop_counter.FlopCounterMode``:

* **train** on the stacked layout: ``train_loss_scanned``, its gradient
  and the AdamW update;
* **prefill**: ``forward_scanned(last_only=True)``;
* **decode**: ``models.decode_step`` against ``cache_specs``.

Each record gives

* ``state_bytes_per_device``: the parameters', the optimizer state's, the
  batch's and (decode) the caches' bytes on one device under
  ``dist/sharding.py``'s rules;
* ``activation_peak_bytes`` / ``step_peak_bytes``: the most fake bytes
  alive at once on top of the state, through the forward and through the
  whole step.  They are one data replica's micro-batch over the whole
  model: the model axis does not split them here;
* ``flops_counted`` (that micro-batch's step, the whole model),
  ``flops_per_device`` (times the accumulation steps, over the model
  axis), ``model_flops_*`` (6·N a token) and ``useful_flop_ratio``;
* ``roofline.compute_s``: ``flops_per_device`` at the dense peak of the
  parameters' dtype on an NVIDIA H100 SXM (``H100_PEAK_FLOPS``).

``hbm_bytes_per_device``, ``collective_bytes_per_device`` and the
roofline's memory and collective terms are ``null``: the reference reads
them off XLA's partitioned program, which the port does not have.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.configs import (ARCHITECTURES, INPUT_SHAPES, get_config,
                                 shape_applicable)
from repro_torch.dist.sharding import (batch_shardings, cache_shardings,
                                       device_bytes, params_shardings,
                                       shard_shape)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import decode_specs, input_specs, state_specs
from repro_torch.models.profiles import model_flops_per_token

# Microbatched gradient accumulation for the biggest trainings (the
# reference's: keeps the per-device activation footprint inside HBM).
ACCUM_STEPS = {
    "grok-1-314b": 8,
    "llava-next-34b": 8,
    "gemma-7b": 4,
    "gemma3-4b": 2,
}

# Dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no sparsity).
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

NULL_TERMS = ("the reference reads HBM and collective bytes off XLA's "
              "partitioned program; the port has none")


def _tokens_per_step(cfg, shape) -> float:
    if shape.mode == "decode":
        return shape.global_batch        # one token per sequence
    return shape.global_batch * shape.seq_len


def _micro(batch_m: Dict[str, torch.Tensor], specs, mesh,
           accum: int) -> Dict[str, torch.Size]:
    """Each batch leaf's per-device shape, its rows split ``accum`` ways."""
    out = {}
    for k, leaf in batch_m.items():
        local = list(shard_shape(leaf.shape, specs[k], mesh))
        if local[0] % accum:
            raise ValueError(f"{k}: {local[0]} rows a device do not split "
                             f"into {accum} micro-batches")
        local[0] //= accum
        out[k] = torch.Size(local)
    return out


def fake_step(arch: str, shape_name: str, *, multi_pod: bool,
              fsdp: bool = True, dtype=torch.bfloat16,
              accum: int | None = None, remat: bool = True,
              cache_seq_over_model: bool = False, barrier: bool = False,
              remat_sqrt: int = 0, moe_ep: bool = False) -> Dict[str, Any]:
    """One combination's step on fake tensors; the record's numbers."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.fake import (LiveBytes, constant_step,
                                         fake_like, fake_mode)
    from repro_torch.models import model as model_lib
    from repro_torch.models import scanned
    from repro_torch.optim import adamw
    from repro_torch.train.loop import opt_tree
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    model_size = mesh.shape["model"]
    state: Dict[str, int] = {}
    opt = adamw(1e-4)

    if shape.mode == "decode":
        params_m, _ = state_specs(cfg, opt, dtype)
        token_m, caches_m = decode_specs(cfg, shape, dtype)
        batch_m = {"token": token_m}
        bsh = batch_shardings(batch_m, mesh)
        csh = cache_shardings(caches_m, mesh, batch=shape.global_batch,
                              seq_over_model=cache_seq_over_model)
        state["caches"] = device_bytes(caches_m, csh, mesh)
        accum = 1
    else:
        params_m = scanned.init_stacked(cfg, None, dtype, "meta")
        batch_m = input_specs(cfg, shape, dtype)
        bsh = batch_shardings(batch_m, mesh)
        if shape.mode == "train":
            if accum is None:
                accum = ACCUM_STEPS.get(arch, 1) \
                    if shape_name == "train_4k" else 1
            opt_m = opt_tree(opt.init(tree.leaves(params_m)), params_m)
            state["opt"] = device_bytes(
                opt_m, params_shardings(cfg, opt_m, mesh, fsdp=fsdp,
                                        moe_ep=moe_ep), mesh)
        else:
            accum = 1
    state["params"] = device_bytes(
        params_m, params_shardings(cfg, params_m, mesh, fsdp=fsdp,
                                   moe_ep=moe_ep if shape.mode == "train"
                                   else False), mesh)
    state["batch"] = device_bytes(batch_m, bsh, mesh)
    micro = _micro(batch_m, bsh, mesh, accum)

    with fake_mode():
        params = fake_like(params_m, requires_grad=shape.mode == "train")
        batch = {k: torch.empty(s, dtype=batch_m[k].dtype)
                 for k, s in micro.items()}
        if shape.mode == "decode":
            b = micro["token"][0]
            caches = model_lib.init_caches(cfg, b, shape.seq_len, dtype)
        if shape.mode == "train":
            leaves = tree.leaves(params)
            opt_state = constant_step(opt.init(leaves))
        with FlopCounterMode(display=False) as flops, LiveBytes() as live:
            if shape.mode == "train":
                loss = scanned.train_loss_scanned(
                    cfg, params, batch, remat=remat, barrier=barrier,
                    remat_sqrt=remat_sqrt)
                activation_peak = live.peak
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
                if accum > 1:    # the reference's fp32 accumulation
                    grads = [torch.zeros(g.shape, dtype=torch.float32)
                             .add_(g.float()).div_(accum) for g in grads]
                opt.update(list(grads), opt_state, leaves)
            elif shape.mode == "prefill":
                with torch.no_grad():
                    scanned.forward_scanned(cfg, params, batch,
                                            mode="prefill", remat=False,
                                            last_only=True)
                activation_peak = live.peak
            else:
                with torch.no_grad():
                    model_lib.decode_step(cfg, params, batch["token"],
                                          caches)
                activation_peak = live.peak
        counted = float(flops.get_total_flops())
        step_peak = live.peak

    flops_dev = counted * accum / model_size
    model_fl = model_flops_per_token(cfg) * _tokens_per_step(cfg, shape)
    if shape.mode != "train":
        model_fl /= 3.0          # forward only (no 2x backward)
    return {
        "chips": mesh.size,
        "device": "fake",
        "accum_steps": accum,
        "micro_batch": {k: list(s) for k, s in micro.items()},
        "state_bytes_per_device": state,
        "activation_peak_bytes": activation_peak,
        "step_peak_bytes": step_peak,
        "flops_counted": counted,
        "flops_per_device": flops_dev,
        "hbm_bytes_per_device": None,
        "collective_bytes_per_device": None,
        "null_terms": NULL_TERMS,
        "roofline": {"compute_s": flops_dev / H100_PEAK_FLOPS[dtype],
                     "peak": f"NVIDIA H100 SXM dense {str(dtype)[6:]}",
                     "memory_s": None, "collective_s": None},
        "model_flops_global": model_fl,
        "model_flops_per_device": model_fl / mesh.size,
        "useful_flop_ratio":
            (model_fl / mesh.size) / flops_dev if flops_dev else None,
    }


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            fsdp: bool = True, verbose: bool = True, **kw) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "mode": shape.mode, "status": "skip" if not ok else "pending",
    }
    if not ok:
        rec["reason"] = reason
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {reason}")
        return rec

    t0 = time.perf_counter()
    try:
        rec.update(fake_step(arch, shape_name, multi_pod=multi_pod,
                             fsdp=fsdp, **kw))
        rec["status"] = "ok"
        rec["fake_step_s"] = round(time.perf_counter() - t0, 2)
        if verbose:
            st = rec["state_bytes_per_device"]
            print(f"[ok] {arch} x {shape_name} x {mesh_name}: fake step "
                  f"{rec['fake_step_s']:.1f}s | compute "
                  f"{rec['roofline']['compute_s']:.3e}s at the "
                  f"{rec['roofline']['peak']} peak | flops/device "
                  f"{rec['flops_per_device']:.3e} (useful "
                  f"{rec['useful_flop_ratio']:.2f}) | per device: params "
                  f"{st['params']} B, opt {st.get('opt')} B | activations "
                  f"{rec['activation_peak_bytes']} B, step "
                  f"{rec['step_peak_bytes']} B a replica micro-batch")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[ERROR] {arch} x {shape_name} x {mesh_name}: {e}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--cache-seq-over-model", action="store_true")
    ap.add_argument("--barrier", action="store_true")
    ap.add_argument("--remat-sqrt", type=int, default=0)
    ap.add_argument("--moe-ep", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = sorted(ARCHITECTURES) if (args.all or not args.arch) \
        else [args.arch]
    shapes = sorted(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape, multi_pod=mp,
                              fsdp=not args.no_fsdp, accum=args.accum,
                              barrier=args.barrier,
                              remat_sqrt=args.remat_sqrt,
                              moe_ep=args.moe_ep,
                              cache_seq_over_model=args.cache_seq_over_model)
                failed += rec["status"] == "error"
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
