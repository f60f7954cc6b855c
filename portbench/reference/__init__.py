"""The plain float32 references the benchmark's correctness check compares
with: a model family's forward, loss and gradients
(``portbench/reference/<family>.py``, found by the configuration's
``family``), AdamW and the first training steps (``train.py``), and a
full forward for serving (``serve.py``).  Plain ``torch`` operations
only; nothing here imports the port, JAX or the JAX package, and nothing
takes what the port made.

A family's module gives ``params_from_stacked(cfg, stacked, grad)``,
``leaf_items(cfg, params)``, ``loss(cfg, params, tokens, labels)``,
``hidden(cfg, params, tokens)`` and ``head(cfg, params, x)``.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict


def of(cfg: Dict[str, Any]) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{cfg['family']}")
