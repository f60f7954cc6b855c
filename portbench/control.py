"""The check's control and planted faults, read at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \
        [--mode tf32|half_batch]

For each seed it puts the reference, computed another way, in the
program's place and prints the numbers the cell's check compares, beside
the cell's limits, one JSON line a seed:

* ``tf32`` (the control): the reference with TF32 on for its products,
  the nearest precision below the configurations' float32 with TF32 off;
* ``half_batch`` (training cells): the reference that leaves out half of
  each batch and takes the mean over the rest.

A training cell's other faults need no run: a step that leaves its state
unchanged, or a push that never arrives (its state then stays as it
was), reads 1 for ``grad_gap`` and ``change_gap`` by their definition.
The benchmark's own runs never run this; a limit is set between the
program's readings and these.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]


def train_readings(cell, seed: int, mode: str, device) -> Dict[str, Any]:
    from portbench.gen.train import Feed
    from portbench.harness import checks, weights
    from portbench.reference import train as reference
    cfg, traffic = cell.config, cell.traffic
    feed = Feed(cfg, traffic, seed, device)
    batches = [feed(i) for i in range(traffic["check_steps"])]
    drawn = weights.draw(cfg, seed, device)
    want = reference.run(cfg, drawn, batches, traffic["lr"])
    if mode == "half_batch":
        half = traffic["batch"] // 2
        batches = [{k: v[:half] for k, v in b.items()} for b in batches]
    got = reference.run(cfg, drawn, batches, traffic["lr"],
                        mode="tf32" if mode == "tf32" else "fp32")
    return checks.train_numbers(got, want)


def serve_readings(cell, seed: int, mode: str, device) -> Dict[str, Any]:
    """Over the cell's own sample size, on requests of the cell's prompt
    lengths (a longest one among them), each prompt followed by
    ``new_tokens - 1`` tokens drawn from the seed: the gap of the token the
    lower precision puts first at each position, and its logit's distance
    from the float32 reference's."""
    import torch
    from portbench.gen.serve import cycle, prompts
    from portbench.harness import weights
    from portbench.reference import of, serve as reference
    if mode != "tf32":
        raise ValueError("a serving cell's control is tf32")
    cfg, traffic = cell.config, cell.traffic
    params = of(cfg).params_from_stacked(cfg, weights.draw(cfg, seed,
                                                           device))
    lengths = sorted(cycle(traffic, seed), reverse=True)
    token_gap = logit_gap = 0.0
    for i in range(traffic["sample_requests"]):
        t = lengths[i % len(lengths)]
        seq = prompts(cfg, seed, 3 * 10 ** 6 + i, 1,
                      t + traffic["new_tokens"] - 1, device).long()
        want = reference.logits(cfg, params, seq, t - 1)[0]
        got = reference.logits(cfg, params, seq, t - 1, mode="tf32")[0]
        first = got.argmax(dim=-1)
        at = want.gather(1, first[:, None])[:, 0]
        token_gap = max(token_gap, float((want.max(-1).values - at).max()))
        logit_gap = max(logit_gap, float((got.max(-1).values - at)
                                         .abs().max()))
        del want, got
        if seq.is_cuda:
            torch.cuda.empty_cache()
    return {"token_gap": token_gap, "logit_gap": logit_gap}


def readings(cell, seed: int, mode: str, device) -> Dict[str, Any]:
    fn = train_readings if cell.kind == "train" else serve_readings
    return fn(cell, seed, mode, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=("tf32", "half_batch"),
                    default="tf32")
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
        numbers = readings(cell, seed, args.mode, device)
        where = numbers.pop("where", None)
        print(json.dumps({"workload": cell.name, "mode": args.mode,
                          "seed": seed, "numbers": numbers,
                          "limits": cell.limits,
                          "fails": any(numbers[k] > v
                                       for k, v in cell.limits.items()),
                          "where": where}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
