"""The port's examples run in this process, and their text compared.

``examples/torch_<name>.py`` is the port's counterpart of
``examples/<name>.py``.  Two runs of an example differ by design in their
wall-clock figures and in the values that depend on the weights (losses,
sampled token ids: torch cannot replay ``jax.random``), so texts are
compared after ``mask_example_text``; the reference's text is first
translated where the port differs by design (``translate_reference_text``).
Used by ``tests/test_torch_examples*.py``, ``tests/test_torch_gpu.py``,
``tests/helpers/example_texts.py`` and ``chip_smoke.py`` phase
``examples``.  Imports torch and numpy only.
"""

import contextlib
import hashlib
import io
import math
import re
import runpy
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
# the reference examples' text at their defaults on one device,
# translated and masked (tests/helpers/example_texts.py writes them)
EXAMPLE_TEXTS = ROOT / "tests" / "fixtures" / "examples"
# each example and the small flags of its CPU tests and of the card /
# CPU twins (where the reference exposes no flag, its default)
EXAMPLES = {"quickstart": (), "paper_cnn_study": (),
            "edge_training": ("--layers", "2", "--d-model", "64",
                              "--steps", "6"),
            "bandwidth_drift": ("--layers", "2", "--d-model", "64",
                                "--steps", "6", "--steps-per-epoch", "2"),
            "edge_ps": ("--steps", "4", "--async-pushes", "8"),
            "dynamic_ps": ("--steps", "6", "--steps-per-epoch", "2",
                           "--async-pushes", "8"),
            "edge_pipeline": ("--steps", "2"),
            "elastic_fleet": ("--pushes", "6"),
            "serving": ("--tokens", "8")}
HOST_EXAMPLES = ("quickstart", "paper_cnn_study")   # they place no tensor
# a finite decimal: a loss the mask hides must be one, so a NaN or an
# infinity stays in the text and differs from the reference's
NUMBER = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"
LOSSES = (rf"loss ({NUMBER})", rf"-> ({NUMBER}) over")
# what differs between two runs of an example by design: wall-clock
# figures (the DP's host time against its window in ``hidden=``
# included) and values that depend on the weights
EXAMPLE_MASKS = ((r"sched [\d.]+ ms", "sched <ms> ms"),
                 (r"scheduling took [\d.]+ ms", "scheduling took <ms> ms"),
                 (r"at [\d.]+s/step", "at <s>s/step"),
                 (r"in [\d.]+s = [\d.]+ tok/s", "in <s>s = <n> tok/s"),
                 (r"hidden=\w+", "hidden=<clock>"),
                 (LOSSES[0], "loss <loss>"),
                 (LOSSES[1], "-> <loss> over"),
                 (r"token ids: \[[^\]]*\]", "token ids: [<ids>]"))
# the reference's text -> the port's, where they differ by design: the
# port has no HLO, so a plan line counts the collectives its first step
# launched, and a pointer to another example names the port's script
EXAMPLE_TRANSLATION = (("(hlo ", "(coll "),
                       ("examples/dynamic_ps.py",
                        "examples/torch_dynamic_ps.py"))


def example_path(name: str, port: bool = True) -> Path:
    return ROOT / "examples" / (f"torch_{name}.py" if port else f"{name}.py")


def mask_example_text(text: str) -> str:
    """An example's stdout with ``EXAMPLE_MASKS`` applied: what is left
    (plans, buckets, collectives, events, pushes, staleness, ledgers,
    partitions, timelines, planner stats) must equal between two runs."""
    for pattern, repl in EXAMPLE_MASKS:
        text = re.sub(pattern, repl, text)
    return text


def translate_reference_text(text: str) -> str:
    for old, new in EXAMPLE_TRANSLATION:
        text = text.replace(old, new)
    return text


def printed_losses(text: str) -> list:
    """The losses the mask hides, in the order printed, as strings."""
    found = []
    for m in re.finditer("|".join(LOSSES), text):
        found.append(m.group(1) or m.group(2))
    return found


def printed_losses_agree(got: list, want: list, rtol: float) -> float:
    """Two runs' printed losses, one for one: each pair within ``rtol`` of
    the second's magnitude plus one unit of its last printed digit (two
    runs a roundoff apart can print either side of a rounding).  Returns
    the largest gap in units of that bound (at most 1); raises if they
    differ in number or are not finite."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} printed losses against "
                             f"{len(want)}: {got} vs {want}")
    worst = 0.0
    for a, b in zip(got, want):
        x, y = float(a), float(b)
        digits = len(b.split(".")[1]) if "." in b else 0
        bound = rtol * abs(y) + 10.0 ** -digits
        if not (math.isfinite(x) and math.isfinite(y)) or \
                abs(x - y) > bound:
            raise AssertionError(f"printed losses {got} vs {want}: {a} "
                                 f"against {b} (bound {bound:.3g})")
        worst = max(worst, abs(x - y) / bound)
    return worst


def run_example(path, argv=()) -> str:
    """The script at ``path`` run as ``__main__`` in this process, with
    ``sys.argv`` = [path, *argv]: its stdout."""
    buf, saved = io.StringIO(), sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


@contextlib.contextmanager
def host_draws():
    """While open, ``torch.randn`` and ``torch.rand`` given a generator on
    the card draw from a CPU generator seeded with that generator's seed
    (one CPU twin a card generator, advanced draw by draw) and move the
    draw to the card.  The port draws its weights and its samples only
    through these two calls (``models/layers.py``, ``models/ssm.py``,
    ``models/cnn.py``, ``serve/decode.py``) and its data with numpy, so an
    example run under it on the card starts from the weights its
    ``--device cpu`` run draws, and the two runs' numbers can be held
    against each other."""
    import torch
    saved = torch.randn, torch.rand
    twins = {}

    def twin(gen):
        if gen is None or gen.device.type == "cpu":
            return None
        if id(gen) not in twins:         # the generator is kept alive here
            twins[id(gen)] = (gen, torch.Generator().manual_seed(
                gen.initial_seed()))
        return twins[id(gen)][1]

    def on_the_host(draw):
        def drawn(*shape, generator=None, device=None, **kw):
            cpu = twin(generator)
            if cpu is None:
                return draw(*shape, generator=generator, device=device, **kw)
            return draw(*shape, generator=cpu, device="cpu", **kw).to(
                generator.device if device is None else device)
        return drawn
    torch.randn, torch.rand = (on_the_host(d) for d in saved)
    try:
        yield
    finally:
        torch.randn, torch.rand = saved


def flats_sha256(flats) -> str:
    """SHA-256 of flat buffers' float32 bytes, in order (numpy arrays or
    tensors on any device)."""
    digest = hashlib.sha256()
    for f in flats:
        if hasattr(f, "detach"):
            f = f.detach().cpu().numpy()
        digest.update(np.ascontiguousarray(f, np.float32).tobytes())
    return digest.hexdigest()
