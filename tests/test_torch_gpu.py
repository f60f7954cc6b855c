"""The port's CUDA kernels and main path on a card (skipped without one).

This file imports no JAX and nothing of the reference package, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same card
tensors: pack / unpack bitwise, flash attention at the reference's
tolerances (atol 2e-6 in f32, 2e-2 in bf16).
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.bucket_pack import ops, ref
from repro_torch.kernels.flash_attention import ops as flash_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_bitwise_vs_plain(cuda, dtype):
    base = torch.randn(10007, device=cuda).to(dtype)
    pieces = [base[3:1030], 5, base[1:2], base[100:4197]]
    before = launch_counts()
    got = ops.pack_ragged(pieces)
    assert torch.equal(got, ref.pack_ragged_ref(pieces, dtype=dtype,
                                                device=cuda))
    widths = [1027, 5, 1, 4097]                  # the pieces' lengths
    for a, b in zip(ops.unpack_columns(got, widths, 1),
                    ref.unpack_columns_ref(got, widths, 1)):
        assert torch.equal(a, b)
    segs, alens = ops.pad_segments([base[:700], base[:512]])
    flat = ops.bucket_pack(segs, alens)
    assert torch.equal(flat, ref.bucket_pack_ref(segs, alens))
    assert torch.equal(ops.bucket_unpack(flat, alens, segs.shape[1]),
                       ref.bucket_unpack_ref(flat, alens, segs.shape[1]))
    after = launch_counts()
    assert after["bucket_pack"] == before["bucket_pack"] + 2
    assert after["bucket_unpack"] == before["bucket_unpack"] + 2


@pytest.mark.parametrize("case", [
    # (b, h, hkv, t, hd, causal, window, cap)
    (1, 2, 1, 128, 64, True, 0, 0.0),
    (1, 2, 2, 256, 64, True, 100, 30.0),
    (1, 2, 2, 128, 80, False, 0, 0.0),
    (2, 4, 4, 16, 64, True, 0, 0.0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_vs_plain(cuda, case, dtype):
    b, h, hkv, t, hd, causal, window, cap = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, t, h, hd, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, t, hkv, hd, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal, window, cap)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(flash_ops.flash_attention(*args).float(),
                               flash_ops._ref_fwd(*args).float(),
                               atol=tol, rtol=0)


def test_flash_gradient_is_the_plain_vjp(cuda):
    q, k, v = (torch.randn(1, 2, 64, 64, device=cuda, requires_grad=True)
               for _ in range(3))
    (flash_ops.flash_attention(q, k, v) ** 2).sum().backward()
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (flash_ops._ref_fwd(q, k, v, True, 0, 0.0) ** 2).sum().backward()
    for a, x in zip(got, (q, k, v)):
        torch.testing.assert_close(a, x.grad, atol=1e-5, rtol=1e-5)


def test_zero_smoke_config_runs_through_the_kernels(cuda):
    from repro_torch.runtime import RuntimeConfig, build_runtime
    rt = build_runtime(RuntimeConfig.load(os.path.join(
        ROOT, "examples", "runtime_configs", "zero.json")))
    assert rt.device.type == "cuda"
    reset_launch_counts()
    try:
        losses = rt.fit(2)
    finally:
        torch.distributed.destroy_process_group()
    plan = rt.plan
    assert np.all(np.isfinite(losses))
    assert launch_counts() == {
        "bucket_pack": 2 * (len(plan.forward) + len(plan.backward)),
        "bucket_unpack": 2 * len(plan.forward),
        "flash_attention_fwd": 2 * 2 * rt.arch.num_layers}
