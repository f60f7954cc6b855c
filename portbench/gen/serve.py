"""Serving traffic: a closed loop of batches through the port's
``serve.decode.batched_generate``.

The traffic file gives ``batch`` same-length prompts a batch, the cycle
of prompt lengths (``prompt_lengths``; its start rotated by the seed),
``new_tokens`` a request, greedy decoding, the prompt length of the batch
traced with ``--trace 1`` and how many served requests the check samples.
The window's unit is one whole cycle, so every seed serves the same set of
lengths in another order.

Times come from CUDA events recorded from ``batched_generate``'s step
hook, after the prefill and after each decode step (the serve launcher's
marks), read once the batch has ended; the loop never waits on the card
inside a batch.  The hook also keeps each step's best logit, the program's
logit of the token it serves (greedy).

Once the window has closed, a sample of the requests it finished, drawn
from the seed with a longest prompt in it, goes through the reference's
full forward over prompt and served tokens.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import families, reference
from portbench.gen.common import sync
from portbench.harness import weights
from portbench.harness.runner import Outcome
from portbench.harness.trace import traced
from portbench.reference import serve as reference_serve

MARK = "portbench.serve.step"


def prompts(cfg, seed: int, index: int, b: int, t: int, device):
    """Batch ``index``'s prompts: ids uniform over the vocabulary."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.subseed(seed, 4, index))
    return torch.randint(0, cfg["vocab_size"], (b, t), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)


class Batch:
    """One ``batched_generate`` call with its marks."""

    def __init__(self, arch, params, tokens, new_tokens: int, device,
                 keep_logits: bool, span: bool = False):
        from repro_torch.serve.decode import batched_generate
        self.cuda = device.type == "cuda"
        self.marks: List[Any] = []
        self.best: List[torch.Tensor] = []
        self.prompt = tokens

        def hook(i, logits, caches):
            if span:
                from torch.profiler import record_function
                with record_function(MARK):
                    pass
            self.marks.append(self._mark())
            if keep_logits and i < new_tokens:
                self.best.append(logits[:, -1].amax(dim=-1))

        self.start = self._mark()
        self.served = batched_generate(arch, params, tokens,
                                       max_new_tokens=new_tokens,
                                       greedy=True, on_step=hook)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(self) -> List[float]:
        """Each mark's ms since the start (after the batch has ended)."""
        if self.cuda:
            return [self.start.elapsed_time(m) for m in self.marks]
        return [(m - self.start) * 1e3 for m in self.marks]


def cycle(traffic, seed: int) -> List[int]:
    lengths = list(traffic["prompt_lengths"])
    r = seed % len(lengths)
    return lengths[r:] + lengths[:r]


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        work_dir) -> Outcome:
    cfg, traffic = cell.config, cell.traffic
    arch = families.of(cfg).arch_for(cfg)
    b, new = traffic["batch"], traffic["new_tokens"]
    if not traffic["greedy"]:
        raise ValueError("the check compares greedy tokens")
    params = weights.program_params(cfg, weights.draw(cfg, seed, device))
    lengths = cycle(traffic, seed)

    # set-up: every prompt length once; the longest with every decode
    # step (its caches are the largest), the others with one
    longest = max(lengths)
    for t in sorted(set(lengths)):
        Batch(arch, params, prompts(cfg, seed, 10 ** 6 + t, b, t, device),
              new if t == longest else 1, device, keep_logits=False)
    sync(device)
    setup_s = time.perf_counter() - t0

    done: List[Dict[str, Any]] = []
    start = time.perf_counter()
    index = 0
    while True:
        for t in lengths:
            run_ = Batch(arch, params, prompts(cfg, seed, index, b, t, device),
                         new, device, keep_logits=True)
            sync(device)
            ms = run_.ms()
            done.append({"index": index, "t": t, "prompt": run_.prompt,
                         "served": run_.served, "best": run_.best,
                         "prefill_ms": ms[0], "gaps": np.diff(ms).tolist()})
            index += 1
        if time.perf_counter() - start >= seconds:
            break
    elapsed = time.perf_counter() - start
    gaps = [g for d in done for g in d["gaps"]]
    facts: Dict[str, Any] = {
        "seconds": elapsed,
        "prefill_ms": sum(d["prefill_ms"] for d in done),
        "prompt_tokens": sum(b * d["t"] for d in done),
        "model_flops": sum(families.of(cfg).flops.serve_batch(
            cfg, b, d["t"], new) for d in done)}
    tr = None
    if trace:
        facts["traced"], tr = traced_batch(arch, params, cfg, traffic, seed,
                                           device, work_dir)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, sample = check(cfg, traffic, seed, done, device)
    return Outcome(
        e2e={"serve_tokens_per_s": len(done) * b * new / elapsed,
             "itl_ms_p95": float(np.percentile(gaps, 95)),
             "setup_s": setup_s},
        numbers=numbers, attempted=len(done) * b, failed=0,
        peak_bytes=peak, facts=facts, trace=tr,
        notes={"numbers": numbers, "batches": len(done),
               "decode_steps": len(gaps), "sampled": sample})


def traced_batch(arch, params, cfg, traffic, seed: int, device, work_dir):
    from repro_torch.kernels import launch_counts
    b, t, new = traffic["batch"], traffic["traced_prompt"], \
        traffic["new_tokens"]
    tokens = prompts(cfg, seed, 2 * 10 ** 6, b, t, device)
    before = launch_counts()
    trace = traced(lambda: (Batch(arch, params, tokens, new, device,
                                  keep_logits=False, span=True),
                            sync(device)),
                   work_dir, device.type == "cuda")
    delta = launch_counts()["flash_attention_fwd"] - \
        before["flash_attention_fwd"]
    marks = trace.span_intervals(MARK)
    facts = {"decode_steps": new,
             "decode_interval": [marks[0][1], marks[-1][0]]
             if len(marks) == new + 1 else None,
             "flash_calls": [{"b": b, "h": cfg["num_attention_heads"],
                              "hkv": cfg["num_key_value_heads"], "t": t,
                              "hd": cfg["head_dim"], "causal": True,
                              "window": 0}] * delta}
    return facts, trace


def check(cfg, traffic, seed: int, done, device):
    """``logit_gap`` and ``token_gap`` over a sample of served requests:
    ``sample_requests`` of them drawn from the seed, one of them from a
    batch with the longest prompt.  The limits file names which are
    compared."""
    b, new = traffic["batch"], traffic["new_tokens"]
    rng = random.Random(seed)
    requests = [(i, r) for i in range(len(done)) for r in range(b)]
    longest = max(d["t"] for d in done)
    first = rng.choice([q for q in requests if done[q[0]]["t"] == longest])
    rest = [q for q in requests if q != first]
    sample = [first] + rng.sample(rest, traffic["sample_requests"] - 1)
    params = reference.of(cfg).params_from_stacked(
        cfg, weights.draw(cfg, seed, device))
    token_gap = logit_gap = 0.0
    for i, r in sample:
        d = done[i]
        served = d["served"][r].long()
        seq = torch.cat([d["prompt"][r].long(), served[:-1]])[None]
        logits = reference_serve.logits(cfg, params, seq, d["t"] - 1)[0]
        best = logits.max(dim=-1).values
        at = logits.gather(1, served[:, None])[:, 0]
        prog = torch.stack([x[r] for x in d["best"]]).to(at.dtype)
        token_gap = max(token_gap, float((best - at).max()))
        logit_gap = max(logit_gap, float((prog - at).abs().max()))
    return ({"token_gap": token_gap, "logit_gap": logit_gap},
            [[done[i]["index"], r, done[i]["t"]] for i, r in sample])
