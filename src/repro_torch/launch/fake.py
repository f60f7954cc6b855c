"""Fake tensors and a fake world: the dry runs' stand-in for a pod.

A dry run builds the production-scale state as *fake* CPU tensors
(``FakeTensorMode``: shapes, dtypes and strides, no storage) and runs one
step on them, so every operation checks its shapes and reports what it
would allocate, and no byte is moved.  The kernels' wrappers see CPU
tensors and take their plain versions, which only propagate shapes here;
nothing touches a card.

* :func:`init_fake_world` starts a default process group on PyTorch's
  ``"fake"`` backend (``FakeStore``): collectives return at once with
  outputs of the right shape, so a ZeRO step runs at any world size.  It
  must be the process's only group, so the dry runs run in a process of
  their own.
* :func:`fake_mode` enters ``FakeTensorMode``.  The optimizer's step count
  is read on the host (AdamW's bias corrections), so a state's step must
  be a *constant* fake tensor (:func:`constant_step`): fake mode then runs
  the count's own arithmetic for real, and the update's arithmetic stays
  the real one's.
* :class:`LiveBytes` follows every storage made inside its window and
  keeps the peak of those still alive: the step's own allocation on top of
  the state.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree


def init_fake_world(world_size: int) -> None:
    """A default group of ``world_size`` ranks on the ``"fake"`` backend
    (this process is rank 0)."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already; a fake world "
                           "needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def fake_mode() -> Iterator[Any]:
    """``FakeTensorMode`` over CPU tensors.  The rotary table cache is
    cleared on entry and exit, so that no fake table outlives the mode
    and no real one enters it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.layers import _rope_table
    _rope_table.cache_clear()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            yield mode
    finally:
        _rope_table.cache_clear()


def fake_like(meta: Any, requires_grad: bool = False) -> Any:
    """A tree of fake CPU tensors shaped like ``meta`` (call inside
    :func:`fake_mode`)."""
    def make(x):
        t = torch.empty(x.shape, dtype=x.dtype)
        return t.requires_grad_() if requires_grad else t
    return tree.tree_map(make, meta)


def constant_step(opt_state, step: int = 0):
    """``opt_state`` with a constant fake step count (call inside
    :func:`fake_mode`), so the host may read it."""
    return opt_state._replace(step=torch.tensor(step, dtype=torch.int32))


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages made inside the window that are still alive:
    ``live`` now, ``peak`` at most."""

    def __init__(self):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _NO_ALLOCATION:
            return out
        # an output on an input's storage (a view, an in-place op) is not
        # an allocation, whenever that storage was made
        inputs = {t.untyped_storage()._cdata
                  for t in _tensors((*args, *kwargs.values()))}
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            storage = t.untyped_storage()
            if storage._cdata not in inputs and storage not in self._seen:
                n = storage.nbytes()
                self._seen[storage] = n
                self.live += n
                weakref.finalize(storage, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


# ops that never allocate (the most frequent under fake mode)
_NO_ALLOCATION = (torch.ops.prim.device.default, torch.ops.aten.detach.default)


def _tensors(values):
    """The tensors among ``values`` and one level of lists inside them."""
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from (x for x in v if isinstance(x, torch.Tensor))
