"""Baseline scheduling strategies the paper compares against.

* Sequential — the default PS: one transmission covering all L layers
  (decision ``[0, L]`` forward, ``[L+1, 1]`` backward).
* LBL — the layer-by-layer transmission strategy (Poseidon-style): every
  layer is its own mini-procedure.
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.core.costmodel import (Segment, singleton_segments_backward,
                                  singleton_segments_forward)


def sequential_forward(L: int) -> Tuple[Segment, ...]:
    return ((1, L),)


def sequential_backward(L: int) -> Tuple[Segment, ...]:
    return ((1, L),)


def lbl_forward(L: int) -> Tuple[Segment, ...]:
    return singleton_segments_forward(L)


def lbl_backward(L: int) -> Tuple[Segment, ...]:
    return singleton_segments_backward(L)
