"""The composable ``Trainer`` protocol every runtime implements.

One interface over all execution regimes — bucketed ZeRO, synchronous PS,
bounded-staleness async PS, and their dynamic (re-planning) variants — so
launchers, examples, and benchmarks drive any of them identically:

* ``fit(steps, eval_fn=..., eval_every=...)`` — run ``steps`` units of
  progress (training steps for the synchronous regimes, accepted
  gradient pushes for the asynchronous ones) against the configured data
  source; returns one loss per unit.  With an ``eval_fn`` (a zero-arg
  callable returning a scalar loss), the runtime calls it every
  ``eval_every`` units and records an :class:`EvalEvent` into
  ``events``; with ``checkpoint_every``/``checkpoint_path``, it calls
  ``save_state`` at every ``checkpoint_every``-unit boundary, so a
  killed run restarts from the last periodic checkpoint bit-identically;
* ``step(batch)`` — one unit of progress on an explicit batch (async
  regimes feed ``batch`` to every worker attempt until the next push
  commits);
* ``events`` — the ``RescheduleEvent`` history (empty for static
  regimes) plus any ``EvalEvent`` records from ``fit(eval_fn=...)``;
* ``timeline()`` — the regime's simulator view of the active plan
  (``IterationTimeline`` / ``PSTimeline`` for synchronous regimes, the
  cumulative ``AsyncRunLog`` for asynchronous ones; ``None`` where no
  plan exists, e.g. the local regime);
* ``ledger`` — cumulative transfer accounting as a plain dict
  (``pull_bytes``/``push_bytes``/``num_pulls``/``num_pushes`` + regime
  extras), uniform across the mesh-collective and server-mediated paths;
* ``save_state(path)`` / ``restore_state(path)`` — checkpoint the model
  (and, for dynamic regimes, the re-planning loop bookkeeping) through
  ``repro_torch.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, \
    runtime_checkable


@dataclasses.dataclass(frozen=True)
class EvalEvent:
    """One evaluation recorded by ``fit(eval_fn=...)``."""

    unit: int        # units of progress consumed when the eval ran
    loss: float


@runtime_checkable
class Trainer(Protocol):
    """Uniform driver interface over every registered runtime."""

    def fit(self, steps: int, *, log_every: int = 0,
            eval_fn: Optional[Callable[[], float]] = None,
            eval_every: int = 0, checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None) -> List[float]:
        """Run ``steps`` units of progress; one loss per unit."""
        ...

    def step(self, batch: Any) -> float:
        """One unit of progress on an explicit batch."""
        ...

    @property
    def events(self) -> Sequence[Any]:
        """Re-scheduling history (empty for static regimes)."""
        ...

    def timeline(self) -> Optional[Any]:
        """The regime's simulator/log view of the active plan."""
        ...

    @property
    def ledger(self) -> Dict[str, Any]:
        """Cumulative transfer accounting."""
        ...

    def save_state(self, path: str) -> None:
        ...

    def restore_state(self, path: str) -> None:
        ...
