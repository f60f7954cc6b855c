"""Print how far the port's compressed ``ps`` and dynamic paths sit from
the reference on the CPU: the numbers behind the tolerances of
``tests/test_torch_ps.py``, ``tests/test_torch_dynamic.py`` and
``tests/test_torch_dynamic_ps.py``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/helpers/torch_parity_report.py

1. ``ps.json`` plain, int8 and top-k (0.01), 5 steps, and
   ``dynamic.json`` / ``dynamic_ps.json`` (plain and int8), 6 steps across
   their plan swap, from the reference's initial state in both packages:
   the largest relative loss gap.
2. One jitted int8 reference step: its error-feedback residuals against
   ``corrected - compressed`` rounded twice (as written) and once (a fused
   multiply-add), on the reference's own gradients (taken out of the step
   by a spy compressor): mismatching elements per sched layer.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CONFIGS = os.path.join(ROOT, "examples", "runtime_configs")
PS_JSON = os.path.join(CONFIGS, "ps.json")
STEPS = 5
DYNAMIC_STEPS = 6


def loss_gaps() -> None:
    from repro.runtime import CompressionConfig as JC
    from repro.runtime import RuntimeConfig as JR
    from repro.runtime import build_runtime as jbuild
    from repro_torch.interop import zero_state_from_numpy
    from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                     build_runtime)
    runs = [("ps", scheme, frac, STEPS)
            for scheme, frac in (("none", None), ("int8", None),
                                 ("topk", 0.01))]
    runs += [("dynamic", "none", None, DYNAMIC_STEPS),
             ("dynamic_ps", "none", None, DYNAMIC_STEPS),
             ("dynamic_ps", "int8", None, DYNAMIC_STEPS)]
    for name, scheme, frac, steps in runs:
        path = os.path.join(CONFIGS, f"{name}.json")
        jrt = jbuild(dataclasses.replace(JR.load(path),
                                         compression=JC(scheme, frac)))
        init = jax.tree_util.tree_map(np.asarray, jrt._state)
        want = jrt.fit(steps)
        rt = build_runtime(dataclasses.replace(
            RuntimeConfig.load(path),
            compression=CompressionConfig(scheme, frac)), device="cpu")
        zero = getattr(rt.trainer, "base", rt.trainer)
        rt._state = zero_state_from_numpy(
            zero, init["flat_params"], init["opt"].mu, init["opt"].nu,
            int(init["opt"].step))
        got = rt.fit(steps)
        gap = np.max(np.abs(np.subtract(got, want)) / np.abs(want))
        print(f"{name}.json {scheme}: {steps}-step losses, largest "
              f"relative gap {gap:.3g}")


def residual_rounding() -> None:
    from repro.compress.compressor import Int8Compressor
    from repro.kernels.bucket_pack.bucket_pack import aligned
    from repro.kernels.compress.ref import (dequantize_unpack_ref,
                                            quantize_pack_ref)
    from repro.ps import PSTrainer
    from repro.runtime import CompressionConfig, RuntimeConfig, build_runtime

    @dataclasses.dataclass(frozen=True)
    class Spy(Int8Compressor):
        def feedback_roundtrip(self, flat, residual):
            corrected = flat + residual
            return self.roundtrip(corrected), corrected

    cfg = dataclasses.replace(RuntimeConfig.load(PS_JSON),
                              compression=CompressionConfig("int8"))
    rt = build_runtime(cfg)
    batch = rt._batch_fn(0)
    real, _ = rt._step_fn(rt._state, batch)
    tr = rt.trainer
    spy = PSTrainer(cfg=tr.cfg, mesh=tr.mesh, plan=tr.plan,
                    optimizer=tr.optimizer, topology=tr.topology,
                    compressor=Spy(error_feedback=True, use_kernel=False))
    spied, _ = jax.jit(spy.build_train_step())(build_runtime(cfg)._state,
                                               batch)
    quantize = jax.jit(quantize_pack_ref, static_argnums=1)
    for l, (g, r) in enumerate(zip(spied["residuals"], real["residuals"])):
        g, r = np.asarray(g[0]), np.asarray(r[0]).view(np.int32)
        n = g.shape[0]
        npad = aligned(n)
        p, s = quantize(jnp.pad(jnp.asarray(g), (0, npad - n))[None],
                        (npad,))
        c = np.asarray(dequantize_unpack_ref(p, s, (npad,), npad))[0, :n]
        twice = (g - c).view(np.int32)
        q = np.asarray(p)[:n].astype(np.float64)
        once = (g.astype(np.float64) - q * np.repeat(
            np.asarray(s, np.float64), 512)[:n]).astype(np.float32)
        print(f"int8 residual, sched layer {l} ({n} elements): rounded "
              f"twice differs in {int(np.sum(twice != r))}, once in "
              f"{int(np.sum(once.view(np.int32) != r))}")


if __name__ == "__main__":
    loss_gaps()
    residual_rounding()
