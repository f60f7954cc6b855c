"""AdamW's update through ``kernels/adamw`` on the CPU.

On the CPU every buffer takes the plain loop (``kernels/adamw/ref.py``),
so ``adamw().update`` is that loop bitwise; the dispatch predicate sends
real CUDA buffers to the kernel (``csrc/adamw.cu``) and refuses those it
cannot update in place.  ``tests/test_torch_gpu.py`` holds the kernel
bitwise to the plain loop on a card.
"""

import os
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.adamw import ops
from repro_torch.kernels.adamw.ref import adamw_update_ref
from repro_torch.optim.optimizers import adamw

LR = 1e-3
STEPS = 5


def _bits(x):
    return x.view(torch.int32)


def _buffers(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=gen), [
        torch.randn(n, generator=gen) for _ in range(STEPS)]


def _plain_steps(p, grads, weight_decay):
    """``STEPS`` updates of ``p`` by ``ref.py`` alone, with the bias
    corrections taken as ``adamw().update`` takes them."""
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    for t, g in enumerate(grads, start=1):
        step = np.float32(t)
        b1c = float(np.float32(1.0) - np.float32(0.9) ** step)
        b2c = float(np.float32(1.0) - np.float32(0.999) ** step)
        adamw_update_ref(g, p, m, v, lr=LR, b1=0.9, b2=0.999, eps=1e-8,
                         weight_decay=weight_decay, b1c=b1c, b2c=b2c)
    return p, m, v


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("n", [1, 5, 1027, 65539])
def test_update_is_bitwise_the_plain_loop(n, weight_decay):
    p0, grads = _buffers(n, seed=n)
    opt = adamw(LR, weight_decay=weight_decay)
    params = [p0.clone()]
    state = opt.init(params)
    for g in grads:
        out, state = opt.update([g], state, params)
        assert out is params
    want_p, want_m, want_v = _plain_steps(p0.clone(), grads, weight_decay)
    assert int(state.step) == STEPS
    for got, want in ((params[0], want_p), (state.mu[0], want_m),
                      (state.nu[0], want_v)):
        assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(params[0], p0)


def test_a_none_gradient_leaves_its_buffer_and_moments_alone():
    opt = adamw(LR, weight_decay=0.01)
    params = [torch.randn(7), torch.randn(9)]
    kept = params[1].clone()
    state = opt.init(params)
    for _ in range(3):
        opt.update([torch.randn(7), None], state, params)
    assert torch.equal(_bits(params[1]), _bits(kept))
    assert not state.mu[1].any() and not state.nu[1].any()
    assert state.mu[0].any() and int(state.step) == 3


def _fake_cuda(monkeypatch):
    """Fake CUDA tensors that the predicate takes for real ones."""
    monkeypatch.setattr(ops, "is_fake", lambda t: False)
    return FakeTensorMode()


def test_the_predicate_takes_real_cuda_float32_contiguous_buffers(
        monkeypatch):
    with _fake_cuda(monkeypatch):
        t = [torch.empty(12, device="cuda") for _ in range(4)]
        assert ops.fusable(*t)


@pytest.mark.parametrize("change", ["dtype", "strided", "length", "device",
                                    "cpu"])
def test_the_predicate_sends_odd_buffers_to_the_plain_loop(monkeypatch,
                                                           change):
    """On the card no buffer falls back to the plain loop: a ``p``, ``m``
    or ``v`` the kernel cannot update in place, unequal lengths and a
    second device raise."""
    with _fake_cuda(monkeypatch):
        g, p, m, v = (torch.empty(12, device="cuda") for _ in range(4))
        if change == "dtype":
            p = torch.empty(12, device="cuda", dtype=torch.bfloat16)
        elif change == "strided":
            m = torch.empty_strided((12,), (2,), device="cuda")
        elif change == "length":
            v = torch.empty(13, device="cuda")
        elif change == "device":
            m = torch.empty(12, device="cuda:1")
        else:
            m = torch.empty(12)
        with pytest.raises(ValueError, match="adamw"):
            ops.fusable(g, p, m, v)


@pytest.mark.parametrize("change", ["dtype", "strided"])
def test_an_odd_gradient_reaches_the_kernel_as_contiguous_float32(
        monkeypatch, change):
    """The kernel reads ``g`` as the plain loop's ``g.float()`` does (here
    ``meta`` tensors stand in for the card's)."""
    launched = []
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda g, *a, **k: launched.append(g))
    p, m, v = (torch.empty(12, device="meta") for _ in range(3))
    g = torch.empty(12, device="meta", dtype=torch.bfloat16) \
        if change == "dtype" else \
        torch.empty_strided((12,), (3,), device="meta")
    assert ops.adamw_update(g, p, m, v, lr=LR, b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=0.0, b1c=0.1, b2c=0.001) is True
    (got,) = launched
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.numel() == 12


@pytest.mark.parametrize("where", ["cpu", "meta", "fake"])
def test_cpu_meta_and_fake_tensors_take_the_plain_loop(where):
    if where == "fake":
        with FakeTensorMode():
            t = [torch.empty(12, device="cuda") for _ in range(4)]
            assert not ops.fusable(*t)
        return
    t = [torch.zeros(12, device=where) for _ in range(4)]
    assert not ops.fusable(*t)
    before = ops.LAUNCHES["adamw"]
    ran = ops.adamw_update(*t, lr=LR, b1=0.9, b2=0.999, eps=1e-8,
                           weight_decay=0.0, b1c=0.1, b2c=0.001)
    assert ran is False and ops.LAUNCHES["adamw"] == before


def test_the_counters_count_buffers_and_fused_updates():
    opt = adamw(LR)
    params = [torch.randn(4), torch.randn(3), torch.randn(5)]
    state = opt.init(params)
    tracing.reset_counters()
    opt.update([torch.randn(4), None, torch.randn(5)], state, params)
    assert tracing.counters() == {}            # no profiler: nothing
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                opt.update([torch.randn(4), None, torch.randn(5)], state,
                           params)
        assert tracing.counters() == {"optim.buffers": 4, "optim.fused": 0}
    finally:
        tracing.reset_counters()


def test_the_build_names_the_source_and_its_entry_point():
    assert "adamw" in _build.SOURCES
    with open(os.path.join(_build.CSRC, "adamw.cu")) as fh:
        src = fh.read()
    (params,) = re.findall(
        r'extern "C" int ' + ops.ENTRY + r'\(([^)]*)\)', src)
    assert len(params.split(",")) == len(ops._SIGNATURE)
