"""Print how far the port's serving path sits from the reference on the
CPU: the numbers behind the tolerances of ``tests/test_torch_serve.py``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/helpers/torch_serve_report.py

1. Every decodable family (reduced, as the tests): a 70-token prefill and
   6 decode steps, the worst logit and cache-leaf gap to the reference
   (absolute; xLSTM also against each array's largest magnitude).
2. The rotating window (reduced recurrentgemma-2b and gemma2-2b, window
   64): P = 70, 64 and 40, decoded to T = 100, the worst gaps.
3. xLSTM (8 layers) against the port in float64 (``Tensor.float`` kept in
   float64): each float32 run's worst array gap over its scale, P = 70 and
   300 (the chunkwise prefill) and P = 40 decoded for 60 steps.
4. The port's decode against its own full forward (P = 40, T = 100).

About 2 minutes on one CPU core.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, ".."))
import test_torch_serve as T  # noqa: E402
import torch_trainer_parity as parity  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serve import decode as serve  # noqa: E402


def gaps(mine, theirs):
    """(worst logit gap, worst cache gap, worst gap over the array's
    scale) between two runs of (logits per step, cache copies per step)."""
    (logits, snaps), (want_logits, want_snaps) = mine, theirs
    arrays = list(zip(logits, want_logits))
    for s, w in zip(snaps, want_snaps):
        arrays += [(x, y) for a, b in zip(s, w) for x, y in zip(a, b)
                   if y.size and y.dtype.kind == "f"]
    lg = max(float(np.abs(a.astype(np.float64) - b).max())
             for a, b in zip(logits, want_logits))
    cg = max(float(np.abs(a.astype(np.float64) - b).max())
             for a, b in arrays[len(logits):])
    return lg, cg, max(T._leaf_gap(a, b) for a, b in arrays)


def against_reference(arch, prompt, total):
    cfg, jcfg = T._configs(arch)
    params = T._params(jcfg)
    prompts = T._prompts(cfg, 2, prompt)
    logits, snaps, fed = T._reference_run(jcfg, params, prompts,
                                          total - prompt, max_len=total)
    mine = T._port_run(cfg, params_from_numpy(params), prompts, fed,
                       max_len=total)
    return cfg, params, prompts, fed, mine, (logits, snaps)


def main():
    print("1. prefill 70 + 6 decode steps against the reference")
    for arch in T.DECODE_ARCHS:
        *_, mine, theirs = against_reference(arch, 70, 76)
        lg, cg, rel = gaps(mine, theirs)
        print(f"   {arch:22s} logits {lg:.3g}  caches {cg:.3g}  "
              f"over scale {rel:.3g}")
    print("2. the rotating window (window 64), decoded to T = 100")
    for arch in ("recurrentgemma-2b", "gemma2-2b"):
        for prompt in (70, 64, 40):
            *_, mine, theirs = against_reference(arch, prompt, 100)
            lg, cg, _ = gaps(mine, theirs)
            print(f"   {arch:18s} P = {prompt}: logits {lg:.3g}  "
                  f"caches {cg:.3g}")
    print("3. xLSTM against the port in float64 (gap over each array's "
          "scale)")
    for prompt, total in ((70, 76), (300, 306), (40, 100)):
        cfg, params, prompts, fed, mine, theirs = against_reference(
            "xlstm-350m", prompt, total)
        exact = parity.in_float64(lambda: T._port_run(
            cfg, tree.tree_map(torch.Tensor.double,
                               params_from_numpy(params)),
            prompts, fed, max_len=total))
        print(f"   P = {prompt}, {total - prompt} steps: port-reference "
              f"{gaps(mine, theirs)[2]:.3g}, port-float64 "
              f"{gaps(mine, exact)[2]:.3g}, reference-float64 "
              f"{gaps(theirs, exact)[2]:.3g}")
    print("4. the port's decode against its full forward (P = 40, T = 100)")
    for arch in ("granite-3-2b", "gemma2-2b", "gemma3-4b", "xlstm-350m",
                 "recurrentgemma-2b", "granite-moe-1b-a400m"):
        changes = {"capacity_factor": 100.0} if "moe" in arch else {}
        cfg, _ = T._configs(arch, **changes)
        params = model.init_params(cfg, torch.Generator().manual_seed(1))
        toks = torch.from_numpy(T._prompts(cfg, 2, 100))
        with torch.inference_mode():
            full, _, _ = model.forward(cfg, params, {"tokens": toks})
            logits, caches = serve.prefill(cfg, params,
                                           {"tokens": toks[:, :40]},
                                           max_len=100)
            errs = [(logits[:, -1] - full[:, 39]).abs().max().item()]
            step = serve.build_decode_step(cfg)
            for i in range(40, 100):
                logits, caches = step(params, toks[:, i:i + 1], caches)
                errs.append((logits[:, 0] - full[:, i]).abs().max().item())
        print(f"   {arch:22s} {max(errs):.3g}")


if __name__ == "__main__":
    main()
