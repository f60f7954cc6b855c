"""Two trees' RG-LRU scan and sparsify kernels on one card, in turns.

    git archive <parent> | tar -x -C build/parent
    git archive $(git write-tree) | tar -x -C build/change
    python3 tests/helpers/kernel_turns.py build/parent build/change

Runs a, b, b, a, each a process of its own from the tree's directory, so
each builds and loads the tree's own kernels, and times them all by one
method, the helpers of the ``chip_smoke.py`` beside this script: a fifth
of a second of warm-up launches (``warm_up``), then 8 samples of 20
launches by CUDA events (``cuda_ms``; the mean and the range), and one
sample with a cold L2 (``cuda_ms_cold``).
Shapes are the paths': the scan at recurrentgemma-2b's (B, T, W) = (2,
1024, 2560) f32, forward and the body of the tree's own
``_RGLRUScan.backward`` (what the hybrid step's backward runs, without
autograd's own host work); sparsify at granite-3-2b's embedding, the
largest sched layer (49,155 x 2,048 f32, the top-k 1% from the tree's
``topk_indices``), beside ``torch.gather``.  Each result is checked
against the plain version first.  Needs a CUDA card; compare two commits
only inside one such call.
"""

import json
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"

RUN = r'''
import importlib.util, json, math, os, sys, types
import torch
# the timing helpers of this script's own chip_smoke.py, for both trees;
# then the tree's own src first on the path
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
sys.path.insert(0, os.path.abspath("src"))
from repro_torch.kernels.compress import ops as cops, ref as cref
from repro_torch.kernels.rglru_scan import ops, ref

def timed(fn):
    smoke.warm_up(fn)
    ks = [smoke.cuda_ms(fn, 20) for _ in range(8)]
    return dict(ms=sum(ks) / len(ks), range=[min(ks), max(ks)],
                cold_l2=smoke.cuda_ms_cold(fn, 20))

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out = {"device": torch.cuda.get_device_name(0)}
a = (torch.rand(2, 1024, 2560, generator=gen, device=dev) * 0.95 + 0.05)
x = torch.randn(a.shape, generator=gen, device=dev)
g = torch.randn(a.shape, generator=gen, device=dev)
assert torch.equal(ops.scan(a, x), ref.rglru_scan_ref(a, x))
out["rglru_scan"] = timed(lambda: ops.scan(a, x))
h = ops.scan(a, x)
ctx = types.SimpleNamespace(saved_tensors=(a, h))
da, dx = ops._RGLRUScan.backward(ctx, g)
want = ref.rglru_scan_ref(torch.nn.functional.pad(a[:, 1:], (0, 0, 0, 1)),
                          g, reverse=True)
assert torch.equal(dx, want)
assert torch.equal(da, want * torch.nn.functional.pad(h[:, :-1],
                                                      (0, 0, 1, 0)))
out["rglru_scan_backward"] = timed(lambda: ops._RGLRUScan.backward(ctx, g))
del a, x, g, h, da, dx, want
n = 49155 * 2048
row = torch.randn(1, n, generator=gen, device=dev) * 1e-3
idx = cops.topk_indices(row, (n,), math.ceil(0.01 * n))
idx_long = idx.long()
assert torch.equal(cops.sparsify(row, idx), cref.sparsify_ref(row, idx))
out["compress_sparsify"] = timed(lambda: cops.sparsify(row, idx))
out["torch.gather"] = timed(lambda: torch.gather(row, 1, idx_long))
print("RESULT " + json.dumps(out))
'''


def main(argv) -> None:
    trees = [Path(d).resolve() for d in argv]
    if len(trees) != 2:
        raise SystemExit(__doc__)
    runs = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        proc = subprocess.run([sys.executable, "-c", RUN, str(SMOKE)],
                              cwd=tree, capture_output=True, text=True)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            raise SystemExit(f"{tree}: the kernel run failed")
        runs.append((tree.name, json.loads(lines[0][len("RESULT "):])))
        print(tree.name, lines[0], flush=True)
    for name in ("rglru_scan", "rglru_scan_backward", "compress_sparsify",
                 "torch.gather"):
        print(f"{name}: " + "; ".join(
            f"{tree} {r[name]['ms']:.4f} [{r[name]['range'][0]:.4f}-"
            f"{r[name]['range'][1]:.4f}] cold {r[name]['cold_l2']:.4f}"
            for tree, r in runs))


if __name__ == "__main__":
    main(sys.argv[1:])
