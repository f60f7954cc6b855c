"""The half-batch fault of a training cell whose batch is one sequence,
read at the cell's own size.

    python3 portbench/half_sequence.py --workload <cell> --seeds 11 12 13

``control.py --mode half_batch`` keeps ``batch // 2`` rows, none of a
batch of 1.  Here the reference that leaves out the second half of each
sequence (and takes the mean over the first) stands in the program's
place against the reference on the whole batch, and each seed prints one
JSON line: the numbers the cell's check compares, beside the cell's
limits, and whether it fails every one of them.  The benchmark's own runs
never run this; a limit is set between the program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device) -> Dict[str, Any]:
    from portbench.gen.train import Feed
    from portbench.harness import checks, weights
    from portbench.reference import train as reference
    cfg, traffic = cell.config, cell.traffic
    feed = Feed(cfg, traffic, seed, device)
    batches = [feed(i) for i in range(traffic["check_steps"])]
    drawn = weights.draw(cfg, seed, device)
    want = reference.run(cfg, drawn, batches, traffic["lr"])
    half = traffic["seq"] // 2
    got = reference.run(cfg, drawn, [{k: v[:, :half] for k, v in b.items()}
                                     for b in batches], traffic["lr"])
    return checks.train_numbers(got, want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness import cell as cells, env
    env.cache_dirs(ROOT)
    cell = cells.resolve(cells.load_benchmark(ROOT), args.workload, ROOT)
    env.require_cards(cell.chips)
    env.strict_float32()
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        numbers = readings(cell, seed, device)
        where = numbers.pop("where", None)
        print(json.dumps({"workload": cell.name, "mode": "half_sequence",
                          "seed": seed, "numbers": numbers,
                          "limits": cell.limits,
                          "fails_all": all(numbers[k] > v
                                           for k, v in cell.limits.items()),
                          "where": where}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
