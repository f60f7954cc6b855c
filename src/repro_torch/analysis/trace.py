"""Executed-collective recorder (takes the place of the reference's HLO
walker, ``repro/analysis/hlo.py``).

PyTorch runs a step eagerly, so there is no compiled module to read the
collectives from.  :func:`record_collectives` instead wraps the
communication functions of ``torch.distributed`` for the duration of a
``with`` block and records one :class:`CollectiveRecord` per call that
the program makes through them: its kind, its operand bytes, the
operand's dtype and the size of the group it ran over.

Kinds are the reference's five (``all-gather``, ``reduce-scatter``,
``all-reduce``, ``all-to-all``, ``collective-permute``); every other
communication call (``broadcast``, ``send`` / ``recv`` / ``isend`` /
``irecv``, ``scatter``, ``gather``, ``reduce``, the ``*_object`` forms,
``barrier``) is recorded under its own name and is always a stray to the
conformance passes.

Operand bytes follow ``analysis/conformance.py``'s header: the input of
an all-gather (the local shards), the stacked input of a reduce-scatter,
the tensor of an all-reduce; list forms sum their tensors (the
reference's tuple-leaf sum), and a ``batch_isend_irecv`` counts the
tensors it sends.  An ``async_op=True`` call is recorded once, where it
is issued (the reference counts a ``-start`` / ``-done`` pair once).  A
call made from inside another recorded call belongs to the outer one.

Recording costs host time only: it reads ``numel() * element_size()``,
never clones, moves no data to the host and never synchronises a stream.
The wrapping is by module attribute, so it sees every call written
``torch.distributed.<name>(...)`` (the port's only form;
``tests/test_torch_hygiene.py`` holds that no module imports a
communication function by name).

Importing this module imports no torch: the summaries are plain Python,
so the conformance passes run over hand-built traces anywhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, \
    Tuple

__all__ = ["COLLECTIVES", "CollectiveRecord", "OTHER_CALLS", "RECORDED",
           "collective_counts", "collective_summary", "record_collectives"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: torch.distributed function -> (kind, position of its operand argument);
#: a name this torch build lacks is skipped
RECORDED: Dict[str, Tuple[str, int]] = {
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_single": ("all-gather", 1),
    "_all_gather_base": ("all-gather", 1),
    "all_gather": ("all-gather", 1),
    "all_gather_coalesced": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 1),
    "reduce_scatter_single": ("reduce-scatter", 1),
    "_reduce_scatter_base": ("reduce-scatter", 1),
    "reduce_scatter": ("reduce-scatter", 1),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_to_all_single": ("all-to-all", 1),
    "all_to_all": ("all-to-all", 1),
    "batch_isend_irecv": ("collective-permute", 0),
}

#: every other communication call: its own kind, all tensors counted
OTHER_CALLS = ("broadcast", "send", "recv", "isend", "irecv", "scatter",
               "gather", "reduce", "all_gather_object",
               "broadcast_object_list", "gather_object",
               "scatter_object_list", "send_object_list",
               "recv_object_list", "barrier", "monitored_barrier")


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One communication call the program made in a recording window."""

    kind: str                     # one of COLLECTIVES, else the call's name
    name: str                     # "<function>.<index in the trace>"
    bytes: int                    # operand bytes (see the module docstring)
    dtype: Optional[str]          # the operand's dtype, e.g. "float32"
    group_size: int               # ranks of the group the call ran over


def _tensors(values: Iterable[Any]) -> List[Any]:
    """The tensors among ``values`` and inside list / tuple values."""
    import torch
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(_tensors(v))
    return out


def _operands(name: str, arguments: Dict[str, Any],
              params: Sequence[str]) -> Tuple[List[Any], Any]:
    """(operand tensors, group) of one bound call."""
    if name == "batch_isend_irecv":
        ops = arguments[params[0]]
        sent = [op.tensor for op in ops
                if getattr(op.op, "__name__", "") in ("isend", "send")]
        return sent, ops[0].group if ops else None
    if name in RECORDED:
        return _tensors([arguments[params[RECORDED[name][1]]]]), \
            arguments.get("group")
    return _tensors(arguments.values()), arguments.get("group")


def _wrap(dist, name: str, real, trace: List[CollectiveRecord],
          depth: List[int]):
    sig = inspect.signature(real)
    params = tuple(sig.parameters)
    kind = RECORDED[name][0] if name in RECORDED else name

    @functools.wraps(real)
    def call(*args, **kwargs):
        depth[0] += 1
        try:
            out = real(*args, **kwargs)
        finally:
            depth[0] -= 1
        if depth[0]:
            return out                   # inside another recorded call
        arguments = sig.bind(*args, **kwargs).arguments
        tensors, group = _operands(name, arguments, params)
        trace.append(CollectiveRecord(
            kind=kind, name=f"{name}.{len(trace)}",
            bytes=sum(t.numel() * t.element_size() for t in tensors),
            dtype=str(tensors[0].dtype).replace("torch.", "")
            if tensors else None,
            group_size=dist.get_world_size(group)))
        return out

    return call


@contextlib.contextmanager
def record_collectives() -> Iterator[List[CollectiveRecord]]:
    """Record every ``torch.distributed`` communication call made inside
    the block; yields the trace (a list, filled as calls return).

    Windows nest: a call inside two windows is recorded in both.  The
    wrapped functions are restored when the block exits, however it
    exits."""
    import torch.distributed as dist
    trace: List[CollectiveRecord] = []
    depth = [0]
    saved = {}
    for name in (*RECORDED, *OTHER_CALLS):
        real = getattr(dist, name, None)
        if real is not None:             # absent from this torch build
            saved[name] = real
            setattr(dist, name, _wrap(dist, name, real, trace, depth))
    try:
        yield trace
    finally:
        for name, real in saved.items():
            setattr(dist, name, real)


def collective_summary(trace: Sequence[CollectiveRecord]
                       ) -> Dict[str, List[Tuple[CollectiveRecord, int]]]:
    """Per-kind list of ``(record, operand_bytes)``: the five collective
    kinds always (empty lists included), then any other call's name in the
    order first seen — the shape of the reference's
    ``repro.analysis.hlo.collective_summary``."""
    out: Dict[str, List[Tuple[CollectiveRecord, int]]] = \
        {k: [] for k in COLLECTIVES}
    for rec in trace:
        out.setdefault(rec.kind, []).append((rec, rec.bytes))
    return out


def collective_counts(trace: Sequence[CollectiveRecord]) -> Dict[str, int]:
    """Per-kind call counts (the five kinds always, zeros included)."""
    return {k: len(v) for k, v in collective_summary(trace).items()}
