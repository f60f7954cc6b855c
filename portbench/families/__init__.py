"""A model family's program side, found by the configuration's ``family``.

``portbench/families/<family>.py`` gives, for a configuration file of
that family: ``arch_for(cfg)``, the port's architecture held to the
file's sizes; ``shapes(cfg)``, the kinds of leaves the benchmark draws;
``program_trees(cfg)``, the port's parameter layout in those leaves'
names; and ``flops``, the module that counts its model FLOPs.  Its plain
reference is ``portbench/reference/<family>.py``
(:func:`portbench.reference.of`).  A new family is these two files.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict


def of(cfg: Dict[str, Any]) -> ModuleType:
    return importlib.import_module(f"portbench.families.{cfg['family']}")
