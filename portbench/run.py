"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  It puts the checkout's ``src`` on its path,
keeps every cache under ``build/portbench/``, refuses to run without as
many CUDA cards as the cell asks for (exit 3, no result), and prints as
its last stdout line one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every compared number with its limit,
which also end stderr.  A run that finds JAX or the JAX package loaded
once its window has closed exits 4 without a result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"{ROOT} holds no src/repro_torch: the benchmark measures "
              f"the port and runs from the root of a checkout",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import cell as cells, env, runner
    dirs = env.cache_dirs(ROOT)
    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    try:
        env.require_cards(cell.chips)
    except env.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    import torch
    env.strict_float32()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, notes = runner.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), device, T0, dirs["work"])
    found = env.forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 4
    runner.emit(line, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
