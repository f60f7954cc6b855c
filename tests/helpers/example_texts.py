"""Write ``tests/fixtures/examples/<name>.txt``: each reference example's
stdout at its defaults on one device, translated and masked
(``torch_examples.py`` beside this file) as ``chip_ex.py`` phase
``examples`` compares the port's with it (the
port's ``examples/torch_<name>.py`` on the card must print this text once
masked).  Each example runs in a process of its own (about 7 minutes in
all, ``edge_training``'s 200 steps the most of it)::

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/helpers/example_texts.py
"""

import os
import subprocess
import sys

import torch_examples as ex

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    env.pop("XLA_FLAGS", None)
    os.makedirs(ex.EXAMPLE_TEXTS, exist_ok=True)
    for name in sys.argv[1:] or ex.EXAMPLES:
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", f"{name}.py")],
            env=env, cwd=ROOT, check=True, capture_output=True,
            text=True).stdout
        path = ex.EXAMPLE_TEXTS / f"{name}.txt"
        path.write_text(ex.mask_example_text(
            ex.translate_reference_text(out)))
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
