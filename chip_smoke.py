#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one CUDA card.

Phases, each printed as it runs; any failure raises and exits non-zero:

1. ``device``: the card, torch, ``nvidia-smi``'s name and power limit, and
   the build of the CUDA kernels from ``src/repro_torch/csrc``;
2. ``kernels``: every kernel of the main path against its plain PyTorch
   version on the card, at the reference's sweep shapes and at the main
   path's shapes, with the kernel's, the plain version's and one library
   call's times beside the least time the card could take;
3. ``main``: 3 ZeRO steps of full-width granite-3-2b under the DynaComm
   plan, with the kernels' launches in those steps asserted against the
   plan;
4. ``configs``: the checked-in ``zero.json`` / ``local.json`` smoke configs
   through the launcher; zero against local to fp32 tolerance, and zero
   bitwise across the four scheduling strategies.

The last lines are ``nvidia-smi``'s line, the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits non-zero
before printing any result.

    python3 chip_smoke.py                   # everything, as a check
    python3 chip_smoke.py --profile         # also trace one main-path step
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12,       # fp32 outside the tensor cores
              torch.bfloat16: 989e12}     # dense bf16 tensor cores
F32_ATOL, BF16_ATOL = 2e-6, 2e-2          # tests/test_kernels.py tolerances
LOSS_RTOL = 1e-5                          # zero vs local: another sum order
STEPS = 3

MAIN = dict(runtime="zero", arch="granite-3-2b", reduced=False, batch=2,
            seq=1024, optimizer="adamw")
PACK_SWEEP = ((512,), (512, 1024), (2048, 512, 512, 1024), (512,) * 7,
              (100, 700, 513))
# (b, h, hkv, t, hd, causal, window, softcap): the reference's sweep
# (tests/test_kernels.py::TestFlashAttention), then ragged tails
FLASH_SWEEP = ((2, 4, 2, 256, 64, True, 0, 0.0),
               (1, 2, 2, 256, 128, True, 128, 0.0),
               (2, 2, 1, 384, 64, True, 0, 50.0),
               (1, 4, 4, 256, 80, False, 0, 0.0),
               (1, 2, 2, 512, 64, True, 100, 30.0),
               (2, 4, 4, 16, 64, True, 0, 0.0),          # smoke configs' T
               (1, 4, 2, 200, 64, True, 64, 0.0),
               (1, 2, 1, 77, 80, False, 0, 0.0))
REPLACES = {
    "bucket_pack": "src/repro/kernels/bucket_pack/bucket_pack.py:76",
    "bucket_unpack": "src/repro/kernels/bucket_pack/bucket_pack.py:124",
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:111",
}
SOURCES = {"bucket_pack": "src/repro_torch/csrc/bucket_pack.cu",
           "bucket_unpack": "src/repro_torch/csrc/bucket_pack.cu",
           "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu"}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def free_cuda() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def assert_bitwise(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or a.dtype != b.dtype or \
            not torch.equal(bits(a), bits(b)):
        raise AssertionError(f"{what}: kernel and plain version differ")


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)}, "
                  f"{torch.cuda.device_count()} card(s); torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}")
    say("device", f"nvidia-smi: {smi}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library("bucket_pack")
    info = _build.BUILD_INFO
    say("device", f"built {', '.join(info['built']) or 'nothing (cached)'} "
                  f"in {time.perf_counter() - t0:.1f} s into "
                  f"{info['directory']}")
    for name, log in info["logs"].items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("device", f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def main_plan_specs():
    """The main path's plan and flat layouts, priced without allocating."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import (DynaCommScheduler, costs_from_profiles,
                                  plan_from_decision)
    from repro_torch.dist.collectives import make_flat_spec
    from repro_torch.models import (num_sched_layers, param_shapes,
                                    sched_layer_trees)
    from repro_torch.models.profiles import layer_profiles
    from repro_torch.runtime import MeasureConfig, NetworkConfig
    arch = get_config(MAIN["arch"])
    costs = costs_from_profiles(
        layer_profiles(arch, InputShape("runtime", MAIN["seq"], MAIN["batch"],
                                        "train")),
        net=NetworkConfig().build(),
        compute_flops_per_s=MeasureConfig().compute_flops_per_s)
    decision = DynaCommScheduler(strategy="dynacomm").decision_for_iteration(
        costs)
    plan = plan_from_decision(*decision, num_sched_layers(arch))
    specs = [make_flat_spec(t, 1)
             for t in sched_layer_trees(param_shapes(arch))]
    return arch, plan, specs


def check_bucket_kernels(gen, dev) -> None:
    from repro_torch.kernels.bucket_pack import ops, ref
    for dtype in (torch.float32, torch.bfloat16):
        for lengths in PACK_SWEEP:
            vecs = [torch.randn(n, generator=gen, device=dev).to(dtype)
                    for n in lengths]
            segs, alens = ops.pad_segments(vecs)
            flat = ops.bucket_pack(segs, alens)
            assert_bitwise(flat, ref.bucket_pack_ref(segs, alens),
                           f"bucket_pack {lengths} {dtype}")
            assert_bitwise(ops.bucket_unpack(flat, alens, segs.shape[1]),
                           ref.bucket_unpack_ref(flat, alens, segs.shape[1]),
                           f"bucket_unpack {lengths} {dtype}")
        # the collective form: views at odd offsets, zero runs, many rows
        base = torch.randn(10007, generator=gen, device=dev).to(dtype)
        segments = [base[3:1030], 5, base[1:2], base[100:4197], 17,
                    base[9000:10007]]
        assert_bitwise(ops.pack_ragged(segments),
                       ref.pack_ragged_ref(segments, dtype=dtype, device=dev),
                       f"pack_ragged {dtype}")
        widths = (7, 1030, 1, 513)
        for rows in (1, 2, 3):
            flat = torch.randn(rows * sum(widths), generator=gen,
                               device=dev).to(dtype)
            for w, a, b in zip(widths, ops.unpack_columns(flat, widths, rows),
                               ref.unpack_columns_ref(flat, widths, rows)):
                assert_bitwise(a, b, f"unpack_columns rows={rows} w={w}")
    say("kernels", f"bucket_pack / bucket_unpack bitwise on "
                   f"{len(PACK_SWEEP)} aligned sweeps and the ragged "
                   f"collective form (rows 1-3), f32 and bf16")


def time_bucket_kernels(gen, dev, plan, specs) -> dict:
    """Pack and unpack at the main path's largest pull bucket."""
    from repro_torch.kernels.bucket_pack import ops, ref
    bucket = max(plan.forward, key=lambda b: sum(specs[l].padded for l in b))
    widths = [specs[l].shard_size for l in bucket]
    shards = [torch.randn(w, generator=gen, device=dev) for w in widths]
    nbytes = 4 * sum(widths)
    bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3   # read once, write once
    iters = 5
    out = {}

    packed = ops.pack_ragged(shards)
    plain = ref.pack_ragged_ref(shards, dtype=torch.float32, device=dev)
    assert_bitwise(packed, plain, "bucket_pack at the main path's bucket")
    del plain
    out["bucket_pack"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: ops.pack_ragged(shards), iters),
        plain_ms=cuda_ms(lambda: ref.pack_ragged_ref(
            shards, dtype=torch.float32, device=dev), iters),
        library_ms=cuda_ms(lambda: torch.cat(shards), iters),
        bound_ms=bound, bound_by="bytes")
    del shards

    fulls = ops.unpack_columns(packed, widths, 1)
    for a, b in zip(fulls, ref.unpack_columns_ref(packed, widths, 1)):
        assert_bitwise(a, b, "bucket_unpack at the main path's bucket")
    del fulls
    grid = packed.view(1, -1)
    out["bucket_unpack"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: ops.unpack_columns(packed, widths, 1), iters),
        plain_ms=cuda_ms(lambda: ref.unpack_columns_ref(packed, widths, 1),
                         iters),
        library_ms=cuda_ms(
            lambda: torch.split_with_sizes_copy(grid, widths, dim=1), iters),
        bound_ms=bound, bound_by="bytes")
    say("kernels", f"main-path bucket: {len(bucket)} layers, "
                   f"{nbytes / 1e9:.3f} GB f32")
    return out


def _qkv(gen, dev, b, h, hkv, t, hd, dtype, model_layout):
    """q (b, h, t, hd) and k, v (b, hkv, t, hd); with ``model_layout`` they
    are (b, t, heads, hd) tensors seen through a transpose, as
    ``models/attention.py`` hands them over."""
    def make(heads):
        if model_layout:
            x = torch.randn(b, t, heads, hd, generator=gen, device=dev)
            return x.to(dtype).transpose(1, 2)
        return torch.randn(b, heads, t, hd, generator=gen,
                           device=dev).to(dtype)
    return make(h), make(hkv), make(hkv)


def live_pairs(t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    total = 0
    for q in range(t):
        hi = q if causal else t - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def check_flash(gen, dev, arch) -> dict:
    from repro_torch.kernels.flash_attention.ops import (_ref_fwd,
                                                         flash_attention)
    import torch.nn.functional as F
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    with torch.no_grad():
        for case in FLASH_SWEEP:
            b, h, hkv, t, hd, causal, window, cap = case
            for dtype in (torch.float32, torch.bfloat16):
                for layout in (False, True):
                    q, k, v = _qkv(gen, dev, b, h, hkv, t, hd, dtype, layout)
                    err = (flash_attention(q, k, v, causal, window, cap)
                           .float() - _ref_fwd(q, k, v, causal, window, cap)
                           .float()).abs().max().item()
                    tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
                    if not err <= tol:
                        raise AssertionError(f"flash {case} {dtype}: max "
                                             f"abs err {err:.3g} > {tol}")
                    worst[dtype] = max(worst[dtype], err)
        say("kernels", f"flash_attention_fwd on {len(FLASH_SWEEP)} sweep "
                       f"cases x 2 layouts: max abs err f32 "
                       f"{worst[torch.float32]:.3g} (atol {F32_ATOL}), bf16 "
                       f"{worst[torch.bfloat16]:.3g} (atol {BF16_ATOL})")

        # the main path's call: (B, T, H, hd) views, GQA 32/8, T = 1024
        b, t, h, hkv, hd = (MAIN["batch"], MAIN["seq"], arch.num_heads,
                            arch.num_kv_heads, arch.head_dim)
        q, k, v = _qkv(gen, dev, b, h, hkv, t, hd, torch.float32, True)
        err = (flash_attention(q, k, v, True, 0, 0.0)
               - _ref_fwd(q, k, v, True, 0, 0.0)).abs().max().item()
        if not err <= F32_ATOL:
            raise AssertionError(f"flash at the main path's shape: max abs "
                                 f"err {err:.3g} > {F32_ATOL}")
        flops = 4 * b * h * hd * live_pairs(t, True, 0)
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        iters = 20
        rec = dict(
            max_abs_err=err,
            ms=cuda_ms(lambda: flash_attention(q, k, v, True, 0, 0.0),
                       iters),
            plain_ms=cuda_ms(lambda: _ref_fwd(q, k, v, True, 0, 0.0), iters),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        say("kernels", f"flash_attention_fwd at (B={b}, H={h}/{hkv}, T={t}, "
                       f"hd={hd}) f32: max abs err {err:.3g}; "
                       f"{flops / rec['ms'] / 1e9:.2f} TFLOP/s")
    return {"flash_attention_fwd": rec}


def phase_kernels(arch, plan, specs) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    check_bucket_kernels(gen, dev)
    records = time_bucket_kernels(gen, dev, plan, specs)
    free_cuda()
    records.update(check_flash(gen, dev, arch))
    free_cuda()
    for name, r in records.items():
        say("kernels", f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f},"
                       f" library {r['library_ms']:.4f}, bound "
                       f"{r['bound_ms']:.4f} by {r['bound_by']})")
    return records


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase_main(profile: bool) -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.runtime import (RuntimeConfig, ScheduleConfig,
                                     build_runtime)
    config = RuntimeConfig(**MAIN, schedule=ScheduleConfig(
        strategy="dynacomm"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = build_runtime(config)
    torch.cuda.synchronize()
    plan = rt.plan
    arch = rt.arch
    say("main", f"{arch.name}: {arch.num_layers} layers, d_model "
                f"{arch.d_model}, heads {arch.num_heads}/{arch.num_kv_heads},"
                f" vocab {arch.vocab_size}; batch {config.batch} x seq "
                f"{config.seq}; built in {time.perf_counter() - t0:.1f} s")
    say("main", f"plan (dynacomm): {len(plan.forward)} pull buckets "
                f"{[len(b) for b in plan.forward]}, {len(plan.backward)} push "
                f"buckets {[len(b) for b in plan.backward]}")

    reset_launch_counts()
    losses, secs = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.extend(rt.fit(1))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()

    expect = {"bucket_pack": STEPS * (len(plan.forward) + len(plan.backward)),
              "bucket_unpack": STEPS * len(plan.forward),
              "flash_attention_fwd": STEPS * 2 * arch.num_layers}
    if counts != expect:
        raise AssertionError(f"launches {counts} != expected {expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    steady = sum(secs[1:]) / len(secs[1:])
    tokens = config.batch * config.seq
    say("main", f"losses {losses}")
    say("main", f"step seconds {[round(s, 4) for s in secs]}; steady "
                f"{steady * 1e3:.1f} ms/step (steps 2-{STEPS}), "
                f"{tokens / steady:.1f} tokens/s; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("main", f"launches over {STEPS} steps {counts} == plan")
    if profile:
        profile_step(rt, steady)
    del rt
    free_cuda()
    return counts


def profile_step(rt, steady: float) -> None:
    """One more step under ``torch.profiler``: device time by kernel, and
    the device's idle share of an untraced steady step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.fit(1)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    say("profile", f"device busy {busy * 1e3:.1f} ms per step = "
                   f"{100 * busy / steady:.1f}% of the untraced steady "
                   f"step ({steady * 1e3:.1f} ms); idle "
                   f"{100 * max(0.0, 1 - busy / steady):.1f}%")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        say("profile", f"{e.self_device_time_total / 1e3:9.2f} ms "
                       f"{e.count:5d}x  {e.key[:80]}")


# ---------------------------------------------------------------------------
# phase 4: the checked-in smoke configs through the launcher
# ---------------------------------------------------------------------------


def phase_configs() -> None:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import main as train_main
    from repro_torch.runtime import RuntimeConfig, build_runtime
    cfgs = ROOT / "examples" / "runtime_configs"
    reset_launch_counts()
    zero = train_main(["--config", str(cfgs / "zero.json"), "--steps",
                       str(STEPS), "--log-every", "0"])
    local = train_main(["--config", str(cfgs / "local.json"), "--steps",
                        str(STEPS), "--log-every", "0"])
    counts = launch_counts()
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel never ran in the configs: {counts}")
    gap = max(abs(a - b) / abs(b) for a, b in zip(zero, local))
    if not gap <= LOSS_RTOL:
        raise AssertionError(f"zero {zero} vs local {local}: rel gap "
                             f"{gap:.3g} > {LOSS_RTOL}")
    say("configs", f"zero.json {zero}; local.json {local}; rel gap "
                   f"{gap:.3g} (rtol {LOSS_RTOL}); launches {counts}")
    base = RuntimeConfig.load(str(cfgs / "zero.json"))
    for strategy in ("sequential", "lbl", "ibatch"):
        cfg = dataclasses.replace(base, schedule=dataclasses.replace(
            base.schedule, strategy=strategy))
        rt = build_runtime(cfg)
        got = rt.fit(STEPS)
        if got != zero:
            raise AssertionError(f"zero/{strategy} losses {got} != "
                                 f"zero/dynacomm {zero}")
        say("configs", f"zero/{strategy}: {len(rt.plan.forward)} pull / "
                       f"{len(rt.plan.backward)} push buckets, losses "
                       f"bitwise equal to dynacomm")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one extra main-path step with torch.profiler")
    args = ap.parse_args(argv)

    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch, plan, specs = main_plan_specs()
    records = phase_kernels(arch, plan, specs)
    counts = phase_main(args.profile)
    phase_configs()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()

    kernels =[dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **records[name]) for name in REPLACES]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
