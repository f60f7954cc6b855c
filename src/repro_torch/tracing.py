"""Spans and counters for the torch profiler, free while it is off.

The port marks its layer boundaries here, and nowhere else:

* :func:`span` is a ``record_function`` span named ``repro_torch.<name>``
  while a torch profiler records, and a bare ``nullcontext`` otherwise;
* :func:`backward_span` opens such a span on the autograd engine's thread
  when the first gradient of a layer's outputs arrives and closes it once
  the gradient of the layer's input is complete;
* :func:`count` adds a value into a per-name accumulator (a device tensor
  stays on the device), and :func:`counters` reads them all back once.

There is no switch besides the profiler itself: spans and counters cover
exactly the window a profiler records, and a run without one pays a flag
check a call (a ``record_function`` entered with no profiler costs ~50x
that).  So ``torch.profiler`` sees the spans on the host and attributes
the kernels they launch, and ``emit_nvtx`` shows them under Nsight.

Nothing of this module is captured into a CUDA graph: while the current
stream captures, :func:`recording` is false, :func:`span` is a no-op
context and :func:`count` adds nothing, so a graph captured under the
profiler is the one captured without it.  What runs inside a graph is
counted on the host around its replay (``serve/graphs.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Union

import torch
from torch.autograd.profiler import record_function

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()
# name -> [device accumulator or None, host accumulator]
_counters: Dict[str, List] = {}


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph."""
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def recording() -> bool:
    """Whether spans and counters take effect now: a torch profiler
    records on this process and no graph is being captured."""
    return torch._C._autograd._profiler_enabled() and not capturing()


def span(name: str):
    """``record_function("repro_torch.<name>")`` while the profiler
    records and no graph is being captured, else a no-op context."""
    if torch._C._autograd._profiler_enabled() and not capturing():
        return record_function(PREFIX + name)
    return _OFF


def backward_span(name: str, x: torch.Tensor,
                  outputs: Sequence[torch.Tensor]) -> None:
    """Span ``name`` over the backward of the layer that took ``x`` and
    gave ``outputs``: opened by the first of the outputs' gradient hooks
    to run, closed by ``x``'s (which runs once its gradient is summed).
    The hooks are registered only while the profiler records and ``x``
    requires a gradient, and change no gradient."""
    if not (torch._C._autograd._profiler_enabled() and x.requires_grad):
        return
    open_: Dict[str, record_function] = {}

    def enter(_grad):
        if not open_ and torch._C._autograd._profiler_enabled():
            rf = record_function(PREFIX + name)
            rf.__enter__()
            open_["span"] = rf

    def leave(_grad):
        rf = open_.pop("span", None)
        if rf is not None:
            rf.__exit__(None, None, None)

    for out in outputs:
        if out.requires_grad:
            out.register_hook(enter)
    x.register_hook(leave)


def count(name: str, value: Union[torch.Tensor, int]) -> None:
    """Add ``value`` into counter ``name`` while the profiler records and
    no graph is being captured.  A tensor is added on its device and never
    read back here."""
    if not torch._C._autograd._profiler_enabled() or capturing():
        return
    acc = _counters.setdefault(name, [None, 0])
    if isinstance(value, torch.Tensor):
        v = value.detach()
        acc[0] = v.clone() if acc[0] is None else acc[0] + v
    else:
        acc[1] += value


def counters() -> Dict[str, Union[int, float]]:
    """Every counter as a host number; the device accumulators are read
    back in one transfer."""
    on_device = [n for n, (d, _) in _counters.items() if d is not None]
    read = {}
    if on_device:
        values = torch.stack([_counters[n][0].reshape(()).double()
                              for n in on_device]).tolist()
        read = dict(zip(on_device, values))
    out = {}
    for n, (d, host) in _counters.items():
        v = host + read.get(n, 0)
        out[n] = int(v) if d is None or not d.is_floating_point() else v
    return out


def reset_counters() -> None:
    _counters.clear()
