"""recurrentgemma-2b's loss over 10 ZeRO steps, port against reference.

The full-width hybrid's loss rises at step 3 on the card (14.925 → 8.222 →
11.105).  This helper asks whether the reduced hybrid does the same in
both packages: the 3-layer reduced recurrentgemma-2b
``(rglru, rglru, local_attn)`` at seq 80, batch 2, AdamW lr 3e-4, 10
``zero`` steps in the reference (JAX on the CPU) and in the port (on the
CPU, from the reference's initial state).  It prints both loss sequences,
the largest relative gap and where each sequence rises, then one JSON
line.  Not a tier-1 test (about a minute)::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/helpers/hybrid_loss_check.py
"""

import dataclasses
import json

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch.configs import get_config
from repro_torch.interop import zero_state_from_numpy
from repro_torch.runtime import RuntimeConfig, build_runtime

ARCH, SEQ, STEPS = "recurrentgemma-2b", 80, 10


def rises(losses):
    return [i + 1 for i in range(1, len(losses)) if losses[i] > losses[i - 1]]


def main():
    kw = dict(runtime="zero", arch=ARCH, reduced=True, batch=2, seq=SEQ)
    jarch = dataclasses.replace(jax_get_config(ARCH).reduced(), num_layers=3)
    arch = dataclasses.replace(get_config(ARCH).reduced(), num_layers=3)
    jrt = jax_build_runtime(JaxRuntimeConfig(**kw), model=jarch)
    init = jax.tree_util.tree_map(np.asarray, jrt._state)
    ref = jrt.fit(STEPS)
    rt = build_runtime(RuntimeConfig(**kw), model=arch, device="cpu")
    rt._state = zero_state_from_numpy(
        rt.trainer, init["flat_params"], init["opt"].mu, init["opt"].nu,
        int(init["opt"].step))
    port = rt.fit(STEPS)
    gap = max(abs(a - b) / abs(b) for a, b in zip(port, ref))
    print(f"{arch.layer_kinds()} seq {SEQ}, {STEPS} zero steps")
    print(f"reference {ref}")
    print(f"port      {port}")
    print(f"largest relative gap {gap:.3g}; rises at steps: reference "
          f"{rises(ref)}, port {rises(port)}")
    print(json.dumps({"reference": ref, "port": port, "max_rel_gap": gap,
                      "rises_reference": rises(ref),
                      "rises_port": rises(port)}))


if __name__ == "__main__":
    main()
