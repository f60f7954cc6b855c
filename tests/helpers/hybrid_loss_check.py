"""recurrentgemma-2b's loss over a few ZeRO steps, port against reference.

The full-width hybrid's loss rises at step 3 on the card (14.925 → 8.222 →
11.105).  This helper asks whether the two packages do the same from one
initial state carried across as numpy arrays: the reference (JAX on the
CPU) and the port (on the CPU) run ``zero`` steps under AdamW at the
runtimes' default rate (3e-4, phase ``hybrid``'s optimizer).  It prints
both loss sequences, the largest relative gap and where each sequence
rises, then one JSON line.  Two sizes and a card mode, none a tier-1
test:

* the default: the 3-layer reduced recurrentgemma-2b ``(rglru, rglru,
  local_attn)`` at seq 80, batch 2, 10 steps, from the reference's
  initial state (about a minute);
* ``--full-width``: the first ``--layers`` layers (default 3; 9 is six
  rglru and three local_attn) of the published model (d_model 2560, lru
  width 2560, 10 / 1 heads of 256, window 2048, d_ff 15360, vocab
  256,000) at seq 1024, batch 2 (phase ``hybrid``'s batch), ``--steps``
  steps (default 4), from the port's own initial state: ``--seed``
  (default 0) drawn by torch's CPU generator (``build_runtime(..., device="cpu")``), whose
  SHA-256 it prints.  ``chip_smoke.py`` draws the same state on the
  card's host, checks the hash and holds the card's losses from it
  against the port's here (``HYBRID_DRAWS``).  The reference holds
  ~27 GiB of host memory at 3 layers and ~40 GiB at 9, so it runs alone
  in a child process and the state crosses in a temporary ``.npz``::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/helpers/hybrid_loss_check.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/helpers/hybrid_loss_check.py \
        --full-width --layers 9

* ``--card --seeds s [s ...]``: the port alone, on a CUDA card, at the
  full width's first ``--layers`` layers, from each seed's host draw (the
  one above) carried to the card, ``--steps`` steps (default 5; TF32
  off): each trajectory, its draw's SHA-256 and where it rises, one JSON
  line a seed.  It imports no JAX.  A sweep of seeds shows how often a
  draw rises, and picks the draw ``chip_smoke.py`` holds::

    PYTHONPATH=src python tests/helpers/hybrid_loss_check.py --card \
        --layers 9 --seeds 0 1 2 3 4 5 6 7
"""

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
from torch_examples import flats_sha256

ARCH = "recurrentgemma-2b"
REDUCED = dict(seq=80, steps=10, layers=3)
FULL = dict(seq=1024, steps=4, layers=3)


def rises(losses):
    return [i + 1 for i in range(1, len(losses)) if losses[i] > losses[i - 1]]


def arch_of(get_config, full_width: bool, layers: int):
    cfg = get_config(ARCH)
    if not full_width:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, num_layers=layers)


def config_kwargs(seq: int, seed: int = 0) -> dict:
    return dict(runtime="zero", arch=ARCH, batch=2, seq=seq, seed=seed)


def reference(full_width: bool, seq: int, steps: int, layers: int,
              flats=None, seed: int = 0):
    """The reference's run from ``flats`` (its own draw when ``None``):
    (initial flat buffers, losses).  The moments start at AdamW's zeros in
    both packages."""
    import jax
    from repro.configs import get_config
    from repro.runtime import RuntimeConfig, build_runtime
    rt = build_runtime(RuntimeConfig(**config_kwargs(seq, seed)),
                       model=arch_of(get_config, full_width, layers))
    own = rt._state["flat_params"]
    if flats is None:
        flats = [np.asarray(f) for f in own]
    else:
        assert [f.shape for f in flats] == [f.shape for f in own]
        rt._state = dict(rt._state, flat_params=[
            jax.device_put(f, o.sharding) for f, o in zip(flats, own)])
    del own
    return flats, rt.fit(steps)


def port_runtime(full_width: bool, seq: int, layers: int, seed: int = 0):
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig, build_runtime
    return build_runtime(RuntimeConfig(**config_kwargs(seq, seed)),
                         model=arch_of(get_config, full_width, layers),
                         device="cpu")


def card_sweep(layers: int, seeds, steps: int) -> None:
    """``--card``: each seed's host draw carried to the card, ``steps``
    steps there."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig, build_runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def drop_group():
        if dist.is_initialized():
            dist.destroy_process_group()
    for seed in seeds:
        drop_group()
        host = port_runtime(True, FULL["seq"], layers, seed)
        init = host._state["flat_params"]
        sha = flats_sha256(init)
        del host
        drop_group()
        rt = build_runtime(RuntimeConfig(**config_kwargs(FULL["seq"], seed)),
                           model=arch_of(get_config, True, layers))
        rt._state = rt.trainer.state_from_flats(init)
        del init
        losses = rt.fit(steps)
        del rt
        drop_group()
        torch.cuda.empty_cache()
        print(json.dumps({"layers": layers, "seed": seed, "sha256": sha,
                          "card": losses, "rises": rises(losses),
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="the first this many layers of the pattern")
    ap.add_argument("--seed", type=int, default=0,
                    help="with --full-width: the port's draw's seed")
    ap.add_argument("--card", action="store_true",
                    help="the port alone on a CUDA card, at full width")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="with --card: the draws' seeds")
    ap.add_argument("--reference-from", nargs=2, default=None,
                    metavar=("IN", "OUT"),
                    help="(internal) run only the reference from the "
                         "buffers in IN and write its losses to OUT")
    args = ap.parse_args()
    if args.card:
        card_sweep(args.layers or FULL["layers"], args.seeds,
                   args.steps or 5)
        return
    size = FULL if args.full_width else REDUCED
    seq, layers = size["seq"], args.layers or size["layers"]
    steps = args.steps or size["steps"]

    if args.reference_from:
        src, out = args.reference_from
        with np.load(src) as z:
            flats = [z[f"arr_{i}"] for i in range(len(z.files))]
        _, losses = reference(True, seq, steps, layers, flats, args.seed)
        np.save(out, np.asarray(losses))
        return

    from repro_torch.interop import zero_state_from_numpy
    t0 = time.perf_counter()
    if args.full_width:
        rt = port_runtime(True, seq, layers, args.seed)
        flats = [f.numpy() for f in rt._state["flat_params"]]
        sha = flats_sha256(flats)
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "init.npz")
            out = os.path.join(tmp, "losses.npy")
            np.savez(src, *flats)
            del rt, flats
            gc.collect()
            subprocess.run([sys.executable, __file__, "--full-width",
                            "--steps", str(steps), "--layers", str(layers),
                            "--seed", str(args.seed),
                            "--reference-from", src, out], check=True)
            ref = [float(x) for x in np.load(out)]
        t_ref = time.perf_counter() - t0
        rt = port_runtime(True, seq, layers, args.seed)
        again = flats_sha256([f.numpy() for f in rt._state["flat_params"]])
        assert again == sha, "the port's draw changed between builds"
    else:
        flats, ref = reference(False, seq, steps, layers)
        sha = flats_sha256(flats)
        t_ref = time.perf_counter() - t0
        rt = port_runtime(False, seq, layers)
        rt._state = zero_state_from_numpy(rt.trainer, flats)
    got = rt.fit(steps)
    arch = rt.arch
    t_port = time.perf_counter() - t0 - t_ref
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    print(f"{arch.layer_kinds()} d_model {arch.d_model}, window "
          f"{arch.sliding_window}, vocab {arch.vocab_size}; batch 2 x seq "
          f"{seq}, {steps} zero steps, AdamW 3e-4, from the "
          f"{f'port seed {args.seed}' if args.full_width else 'reference'}"
          f"'s draw (sha256 "
          f"{sha}; reference {t_ref:.0f} s, port {t_port:.0f} s)")
    print(f"reference {ref}")
    print(f"port      {got}")
    print(f"largest relative gap {gap:.3g}; rises at steps: reference "
          f"{rises(ref)}, port {rises(got)}")
    print(json.dumps({"layers": layers, "seed": args.seed, "sha256": sha, "reference": ref,
                      "port": got, "max_rel_gap": gap,
                      "rises_reference": rises(ref),
                      "rises_port": rises(got)}))


if __name__ == "__main__":
    main()
