"""The port's CUDA kernels and main path on a card (skipped without one).

This file imports no JAX and nothing of the reference package, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same card
tensors: pack / unpack, the four compression kernels, the RG-LRU scan and
its fused backward, the MoE position kernel and the AdamW update bitwise,
flash attention at
the reference's tolerances
(atol 2e-6 in f32, 2e-2 in bf16).  The model families without a kernel of
their own (xLSTM, the audio and vision frontends) run on the card against
the CPU; so does reduced serving, whose decode steps and generate loop run
under ``torch.cuda.set_sync_debug_mode("error")``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.kernels.adamw import ref as adamw_ref
from repro_torch.kernels.bucket_pack import ops, ref
from repro_torch.kernels.compress import ops as compress_ops
from repro_torch.kernels.compress import ref as compress_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_positions import ops as positions_ops
from repro_torch.kernels.moe_positions import ref as positions_ref
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan import ref as scan_ref

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
    (1, 10, 1, 1024, 256, True, 2048, 0.0),      # recurrentgemma-2b's heads
    (1, 2, 1, 300, 256, True, 128, 0.0),         # hd 256, the window bites
    (2, 32, 8, 1024, 64, True, 0, 0.0),          # the main path's call
    (2, 10, 1, 1024, 256, True, 2048, 0.0),      # the hybrid path's call
    (2, 16, 16, 1024, 80, False, 0, 0.0),        # hubert-xlarge's call
    (1, 2, 1, 130, 64, True, 0, 0.0),            # T past a 128-row q tile
    (1, 2, 2, 333, 256, False, 0, 0.0),          # ragged T, no mask
    (1, 2, 2, 70, 96, True, 0, 0.0),             # hd 96 inside 128
    (1, 2, 1, 200, 112, True, 0, 20.0),          # hd 112 inside 128
    (1, 2, 2, 300, 80, True, 37, 0.0),           # window edge inside a tile
    (1, 4, 2, 129, 256, True, 40, 0.0),          # the same at hd 256
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_never_sync_the_stream(cuda, dtype):
    """1,200 pieces over the three alignment classes (16-byte, 4-byte and
    2-byte offsets, and zero runs) packed and split with the sync debug
    mode set to raise: the table goes up without a synchronize."""
    base = torch.randn(50021, device=cuda).to(dtype)
    gen = np.random.default_rng(0)
    pieces = []
    for i in range(1200):
        lo, n = int(gen.integers(0, 40000)), int(gen.integers(1, 300))
        pieces.append(n if i % 7 == 0 else base[lo:lo + n])
    widths = [int(w) for w in gen.integers(1, 90, size=1100)]
    flat = torch.randn(3 * sum(widths), device=cuda).to(dtype)
    torch.cuda.synchronize()
    before = launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = ops.pack_ragged(pieces)
        split = ops.unpack_columns(flat, widths, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = launch_counts()
    assert after["bucket_pack"] == before["bucket_pack"] + 1
    assert after["bucket_unpack"] == before["bucket_unpack"] + 1
    assert torch.equal(_bits(packed), _bits(ref.pack_ragged_ref(
        pieces, dtype=dtype, device=cuda)))
    for a, b in zip(split, ref.unpack_columns_ref(flat, widths, 3)):
        assert torch.equal(_bits(a), _bits(b))


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


@pytest.mark.parametrize("case", [
    # (b, h, hkv, t, hd, hdv, causal)
    (2, 16, 16, 4096, 192, 128, True),           # the Moonlight cell's call
    (1, 16, 4, 333, 192, 128, True),             # GQA 16/4, ragged T
    (1, 4, 2, 200, 192, 128, False),             # GQA, no mask
    (1, 2, 1, 130, 160, 96, True),               # narrower, inside 192/128
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_template_vs_plain(cuda, case, dtype):
    """Q K^T over the q / k head dim, P V over v's narrower one (latent
    attention), against the plain attention; v a strided view of a wider
    tensor, as MLA's decompression hands it over."""
    b, h, hkv, t, hd, hdv, causal = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, t, h, hd, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, t, hkv, hd, generator=gen, device=cuda).to(dtype)
    kv = torch.randn(b, t, hkv, 128 + hdv, generator=gen,
                     device=cuda).to(dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2),
            kv[..., 128:].transpose(1, 2), causal, 0, 0.0)
    before = launch_counts()["flash_attention_fwd"]
    got = flash_ops.flash_attention(*args)
    assert launch_counts()["flash_attention_fwd"] == before + 1
    assert got.shape == (b, h, t, hdv)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), flash_ops._ref_fwd(*args).float(),
                               atol=tol, rtol=0)


def test_flash_split_template_refuses_what_it_cannot_hold(cuda):
    q = torch.randn(1, 2, 64, 256, device=cuda)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q[..., :128])
    q = torch.randn(1, 2, 64, 192, device=cuda)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, torch.randn(1, 2, 64, 160,
                                                    device=cuda))


def test_flash_split_gradient_is_the_plain_vjp(cuda):
    q, k = (torch.randn(1, 4, 96, 192, device=cuda, requires_grad=True)
            for _ in range(2))
    v = torch.randn(1, 4, 96, 128, device=cuda, requires_grad=True)
    (flash_ops.flash_attention(q, k, v) ** 2).sum().backward()
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (flash_ops._ref_fwd(q, k, v, True, 0, 0.0) ** 2).sum().backward()
    for a, x in zip(got, (q, k, v)):
        torch.testing.assert_close(a, x.grad, atol=1e-5, rtol=1e-5)


# The equal-width instances' outputs at fixed inputs (a CPU generator's
# draws, moved to the card), as SHA-256 of their bytes: read from the
# kernel before the 192 / 128 template joined it, and the same from the
# kernel with it (H100 80GB HBM3, CUDA 12.8's nvcc, torch 2.11).  A change
# that moves a bit of hd 64, 80 / 128 or 256 fails here; another nvcc may
# compile other bits, and then the digests are read again from the kernel
# as it was.
EQUAL_WIDTH_DIGESTS = {
    "(2, 32, 8, 1024, 64, True, 0, 'float32')":
        "755ba381666d621ae35ccb1d2d68dcd913a414495c9e025d3a3f086cabe1ad67",
    "(1, 16, 8, 777, 128, True, 0, 'float32')":
        "37e013d261e3d4875b2da306ae42277187cd72de4ec771d2a7a50766f2d9e5a4",
    "(1, 16, 16, 640, 80, False, 0, 'float32')":
        "02f93dc3c185dd7cdd888bd127c0e198aff452419a0e95d1d35bd7df4c4aa183",
    "(2, 10, 1, 1024, 256, True, 2048, 'float32')":
        "a02d3fe76d8c64dcfb76218606e2da1bb423de466c8ed3d523334a669bde1265",
    "(1, 4, 2, 300, 256, True, 128, 'bfloat16')":
        "0bbde67903fc1dd1a358ee8c0b6744cb3afaa08f62b3da51018ba004fef3d21d",
    "(1, 8, 4, 513, 64, True, 0, 'bfloat16')":
        "503be83bbaefa54b71ebd02a8b8582c8b0f572a73c09db771fb930e4668b698d",
}


@pytest.mark.parametrize("case", list(EQUAL_WIDTH_DIGESTS))
def test_flash_equal_width_instances_keep_their_bits(cuda, case):
    import ast
    import hashlib
    b, h, hkv, t, hd, causal, window, dt = ast.literal_eval(case)
    gen = torch.Generator().manual_seed(1000 + list(
        EQUAL_WIDTH_DIGESTS).index(case))
    dtype = getattr(torch, dt)
    q = torch.randn(b, h, t, hd, generator=gen).to(dtype).to(cuda)
    k, v = (torch.randn(b, hkv, t, hd, generator=gen).to(dtype).to(cuda)
            for _ in range(2))
    out = flash_ops.flash_attention(q, k, v, causal, window, 0.0)
    digest = hashlib.sha256(out.contiguous().view(torch.uint8).cpu()
                            .numpy().tobytes()).hexdigest()
    assert digest == EQUAL_WIDTH_DIGESTS[case]


def test_mla_layer_on_the_card_is_the_cpus(cuda):
    """A reduced Moonlight's three blocks (the dense layer 0 and two MoE
    layers, latent attention throughout) forward and backward on the card
    against the CPU from one draw: every MLA call through the 192 / 128
    template (q / k 24 and v 16 inside it), one launch a layer, each
    counted as that template's; the loss
    within 2e-5 of itself, gradients within 1e-4 of each leaf's largest
    (float32 sums in other orders).  Every token routes to all 8 experts,
    so no near-tie of the router can choose differently on the two
    devices."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b").reduced(
        d_model=64, vocab=128), num_layers=3, num_experts=8, top_k=8,
        capacity_factor=8.0)
    params = model.init_params(cfg, torch.Generator().manual_seed(1))
    tokens = torch.randint(0, 128, (2, 40),
                           generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1)}
    out = {}
    for dev in ("cpu", cuda):
        p = tree.tree_map(lambda x: x.to(dev).requires_grad_(), params)
        reset_launch_counts()
        loss = model.train_loss(cfg, p, {k: v.to(dev)
                                         for k, v in batch.items()})
        launches = (launch_counts()["flash_attention_fwd"],
                    flash_ops.NARROW_V_LAUNCHES["flash_attention_fwd@mla"])
        grads = torch.autograd.grad(loss, tree.leaves(p), allow_unused=True,
                                    materialize_grads=True)
        out[str(dev)] = (loss.item(), [g.cpu() for g in grads], launches)
    (l_cpu, g_cpu, n_cpu), (l_card, g_card, n_card) = out.values()
    assert (n_cpu, n_card) == ((0, 0), (3, 3))
    assert abs(l_cpu - l_card) <= 2e-5 * abs(l_cpu)
    for a, b in zip(g_cpu, g_card):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(a.abs().max()), 1e-30)


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
        "flash_attention_fwd": 2 * 2 * rt.arch.num_layers,
        "compress_quantize": 0, "compress_dequantize": 0,
        "compress_sparsify": 0, "compress_densify": 0, "rglru_scan": 0,
        "rglru_scan_bwd": 0, "moe_positions": 0,
        "adamw": 2 * len(rt.trainer.specs)}


def _bias_corrections(t):
    step = np.float32(t)
    return (float(np.float32(1.0) - np.float32(0.9) ** step),
            float(np.float32(1.0) - np.float32(0.999) ** step))


def _assert_same_bits(got, want, what):
    differ = int((_bits(got) != _bits(want)).sum())
    assert differ == 0, (f"{what}: {differ} of {got.numel()} elements differ "
                         f"from the plain loop")


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("n,offset", [(1, 0), (3, 0), (1025, 0),
                                      (4194307, 0), (1025, 1)])
def test_adamw_kernel_bitwise_vs_plain(cuda, n, offset, weight_decay):
    """Five steps from zero moments, the kernel against ``ref.py`` on the
    same card tensors; ``offset`` 1 puts every buffer one element past a
    16-byte boundary (the scalar path).  Gradients span eight orders of
    magnitude, with exact zeros among them."""
    gen = torch.Generator(device=cuda).manual_seed(n + offset)

    def buf():
        return torch.empty(n + offset, device=cuda)[offset:]

    p = buf().normal_(generator=gen)
    kernel = [p, buf().zero_(), buf().zero_()]
    plain = [x.clone() for x in kernel]
    for t in range(1, 6):
        g = buf().normal_(generator=gen)
        g.mul_(torch.empty_like(g).uniform_(-20, 6, generator=gen).exp2_())
        g[::7] = 0.0
        b1c, b2c = _bias_corrections(t)
        args = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=weight_decay, b1c=b1c, b2c=b2c)
        reset_launch_counts()
        assert adamw_ops.adamw_update(g, *kernel, **args) is True
        assert launch_counts()["adamw"] == 1
        adamw_ref.adamw_update_ref(g, *plain, **args)
        for got, want, what in zip(kernel, plain, "pmv"):
            _assert_same_bits(got, want, f"step {t}, {what}")


def test_adamw_kernel_skips_a_none_gradient(cuda):
    from repro_torch.optim import adamw
    opt = adamw(3e-4, weight_decay=0.01)
    params = [torch.randn(1025, device=cuda), torch.randn(64, device=cuda)]
    kept = params[1].clone()
    state = opt.init(params)
    reset_launch_counts()
    for _ in range(3):
        opt.update([torch.randn(1025, device=cuda), None], state, params)
    assert launch_counts()["adamw"] == 3
    _assert_same_bits(params[1], kept, "skipped buffer")
    assert not state.mu[1].any() and not state.nu[1].any()


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_kernel_takes_a_transposed_gradient_bitwise(cuda,
                                                          weight_decay):
    """A gradient that is not contiguous (a transposed weight's) reaches
    the kernel as a contiguous copy, bitwise the plain loop; a strided
    moment is refused, not sent to the plain loop."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    p = torch.randn(96, 40, device=cuda, generator=gen)
    kernel = [p, torch.zeros_like(p), torch.zeros_like(p)]
    plain = [x.clone() for x in kernel]
    for t in range(1, 4):
        g = torch.randn(40, 96, device=cuda, generator=gen).t()
        assert not g.is_contiguous()
        b1c, b2c = _bias_corrections(t)
        args = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=weight_decay, b1c=b1c, b2c=b2c)
        reset_launch_counts()
        assert adamw_ops.adamw_update(g, *kernel, **args) is True
        assert launch_counts()["adamw"] == 1
        adamw_ref.adamw_update_ref(g, *plain, **args)
        for got, want, what in zip(kernel, plain, "pmv"):
            _assert_same_bits(got, want, f"step {t}, {what}")
    strided = torch.zeros(40, 96, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous float32"):
        adamw_ops.adamw_update(g, p, strided, kernel[2], **args)


def _plain_adamw(lr):
    """AdamW whose every buffer goes through ``kernels/adamw/ref.py``: the
    loop the kernel replaced, with ``adamw().update``'s bias
    corrections."""
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import Optimizer

    @torch.no_grad()
    def update(grads, state, params):
        state.step.add_(1)
        b1c, b2c = _bias_corrections(int(state.step))
        for g, p, m, v in zip(grads, params, state.mu, state.nu):
            if g is not None:
                adamw_ref.adamw_update_ref(g, p, m, v, lr=lr, b1=0.9,
                                           b2=0.999, eps=1e-8,
                                           weight_decay=0.0, b1c=b1c,
                                           b2c=b2c)
        return params, state

    return Optimizer(init=adamw(lr).init, update=update)


def test_zero_smoke_steps_through_the_adamw_kernel_are_bitwise_the_loop(
        cuda):
    """Three ZeRO steps of the smoke config with the kernel, then with the
    plain loop from the same seed: losses, shards and both moments
    bitwise; one launch a shard a step, none on the plain run."""
    from repro_torch.runtime import RuntimeConfig, build_runtime
    config = RuntimeConfig.load(os.path.join(
        ROOT, "examples", "runtime_configs", "zero.json"))
    assert config.optimizer == "adamw"
    runs = []
    for plain in (False, True):
        rt = build_runtime(config)
        if plain:
            rt.trainer.optimizer = _plain_adamw(config.lr)
        reset_launch_counts()
        try:
            losses = rt.fit(3)
        finally:
            torch.distributed.destroy_process_group()
        state = rt._state
        runs.append(dict(losses=list(losses),
                         launches=launch_counts()["adamw"],
                         shards=state["flat_params"], mu=state["opt"].mu,
                         nu=state["opt"].nu))
    fused, loop = runs
    assert fused["launches"] == 3 * len(fused["shards"])
    assert loop["launches"] == 0
    assert fused["losses"] == loop["losses"]
    for key in ("shards", "mu", "nu"):
        for i, (a, b) in enumerate(zip(fused[key], loop[key])):
            _assert_same_bits(a, b, f"{key}[{i}]")


def test_adamw_counters_read_every_buffer_fused_on_the_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.optim import adamw
    opt = adamw(3e-4)
    params = [torch.randn(n, device=cuda) for n in (1025, 4, 7)]
    state = opt.init(params)
    tracing.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                opt.update([torch.randn_like(params[0]), None,
                            torch.randn_like(params[2])], state, params)
        c = tracing.counters()
    finally:
        tracing.reset_counters()
    assert c == {"optim.buffers": 4, "optim.fused": 4}


def _bits(x):
    return x.view({4: torch.int32, 2: torch.int16,
                   1: torch.int8}[x.element_size()])


def _assert_bitwise(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("lengths", [(512,), (512, 1024),
                                     (2048, 512, 512, 1024), (512,) * 7])
def test_quantize_dequantize_bitwise_vs_plain(cuda, lengths):
    """Ragged rows, an all-zero tile, a tiny tile, a NaN tile and an
    inf; then the error-feedback residual of the first row."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    segs = torch.randn(len(lengths), max(lengths), generator=gen,
                       device=cuda)
    segs[0, :512] *= 1e-30
    if len(lengths) > 1:
        segs[1, :512] = 0.0                        # all-zero tile
    if len(lengths) > 2:
        segs[2, 7] = float("nan")                  # NaN tile
    if len(lengths) > 3:
        segs[3, 9] = float("inf")
    payload, scales = compress_ops.quantize_pack(segs, lengths)
    want_p, want_s = compress_ref.quantize_pack_ref(segs, lengths)
    _assert_bitwise(payload, want_p)
    _assert_bitwise(scales, want_s)
    lmax = segs.shape[1]
    _assert_bitwise(compress_ops.dequantize_unpack(payload, scales, lengths,
                                                   lmax),
                    compress_ref.dequantize_unpack_ref(payload, scales,
                                                       lengths, lmax))
    n = lengths[0] - 3
    corrected = segs[0, :n].contiguous()
    residual = torch.empty_like(corrected)
    compress_ops.dequantize_unpack(payload, scales, lengths, lmax,
                                   feedback=(corrected, residual))
    _assert_bitwise(residual, compress_ref.feedback_residual_ref(
        corrected, payload, scales))


@pytest.mark.parametrize("k", [1, 37, 600])
def test_topk_sparsify_densify_bitwise_vs_plain(cuda, k):
    gen = torch.Generator(device=cuda).manual_seed(2)
    segs = torch.round(torch.randn(3, 2048, generator=gen, device=cuda) * 4)
    segs[0, :300] = -0.0
    lengths = (2048, 1500, 40)
    idx = compress_ops.topk_indices(segs, lengths, k)
    assert torch.equal(idx.cpu(), compress_ops.topk_indices(
        segs.cpu(), lengths, k))
    assert (idx[2] == -1).sum() == max(0, k - 40)
    vals = compress_ops.sparsify(segs, idx)
    _assert_bitwise(vals, compress_ref.sparsify_ref(segs, idx))
    _assert_bitwise(compress_ops.densify(vals, idx, 2048),
                    compress_ref.densify_ref(vals, idx, 2048))


@pytest.mark.parametrize("scheme,frac", [("int8", None), ("topk", 0.01)])
def test_ps_smoke_config_runs_through_the_compress_kernels(cuda, scheme,
                                                           frac):
    import dataclasses
    from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                     build_runtime)
    cfg = RuntimeConfig.load(os.path.join(ROOT, "examples",
                                          "runtime_configs", "ps.json"))
    rt = build_runtime(dataclasses.replace(
        cfg, compression=CompressionConfig(scheme, topk_fraction=frac)))
    reset_launch_counts()
    try:
        losses = rt.fit(2)
    finally:
        torch.distributed.destroy_process_group()
    assert np.all(np.isfinite(losses))
    layers = rt.trainer.num_layers
    counts = launch_counts()
    names = (("compress_quantize", "compress_dequantize") if scheme == "int8"
             else ("compress_sparsify", "compress_densify"))
    assert {n: counts[n] for n in names} == {n: 2 * layers for n in names}


# Card against CPU for ps.json, 3 steps from one initial state: the largest
# relative loss gaps measured on an H100 80GB HBM3 (700 W) were 4.01e-7
# (plain), 8.02e-8 (int8) and 7.73e-8 (top-k 0.01); the bound is 5x the
# largest.
CARD_CPU_RTOL = 2e-6


@pytest.mark.parametrize("scheme,frac", [("none", None), ("int8", None),
                                         ("topk", 0.01)])
def test_ps_smoke_config_on_the_card_matches_the_cpu(cuda, scheme, frac,
                                                      tmp_path):
    """The composed card path (pad, residual added in place, residual
    written by the dequantize kernel, stable sort, pack of the compressed
    rows) against the port on the CPU, whose plain versions the CPU tests
    hold bitwise to the reference: one initial state (drawn on the CPU,
    restored on the card) and numpy's batches on both."""
    import dataclasses
    from repro_torch.runtime import (CompressionConfig, RuntimeConfig,
                                     build_runtime)
    cfg = dataclasses.replace(
        RuntimeConfig.load(os.path.join(ROOT, "examples", "runtime_configs",
                                        "ps.json")),
        compression=CompressionConfig(scheme, topk_fraction=frac))
    path = str(tmp_path / "init.npz")
    try:
        cpu_rt = build_runtime(cfg, device="cpu")
        cpu_rt.save_state(path)
        want = cpu_rt.fit(3)
    finally:
        torch.distributed.destroy_process_group()
    try:
        card_rt = build_runtime(cfg)
        card_rt.restore_state(path)
        got = card_rt.fit(3)
    finally:
        torch.distributed.destroy_process_group()
    gap = np.max(np.abs(np.subtract(got, want)) / np.abs(want))
    print(f"ps.json/{scheme}: card {got}, CPU {want}, rel gap {gap:.3g}")
    assert np.all(np.isfinite(got))
    assert gap <= CARD_CPU_RTOL


@pytest.mark.parametrize("shape", [(1, 200, 100), (3, 17, 33), (1, 1, 5),
                                   (70000, 3, 5), (2, 1024, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_rglru_scan_bitwise_vs_plain(cuda, shape, dtype, reverse):
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = (torch.rand(shape, generator=gen, device=cuda) * 0.95 + 0.05).to(
        dtype)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    before = launch_counts()["rglru_scan"]
    got = scan_ops.scan(a, x, reverse)
    assert launch_counts()["rglru_scan"] == before + 1
    _assert_bitwise(got, scan_ref.rglru_scan_ref(a, x, reverse))


@pytest.mark.parametrize("shape", [(1, 200, 100), (3, 17, 33), (1, 1, 5),
                                   (70000, 3, 5), (2, 1024, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_fused_backward_bitwise_vs_plain(cuda, shape, dtype):
    """The autograd backward is one launch of the fused kernel, bitwise
    the plain composition (pad, reverse loop, multiply)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = (torch.rand(shape, generator=gen, device=cuda) * 0.95 + 0.05).to(
        dtype)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
    h = scan_ops.rglru_scan(ta, tx)
    before = launch_counts()
    h.backward(g)
    after = launch_counts()
    assert after["rglru_scan_bwd"] == before["rglru_scan_bwd"] + 1
    assert after["rglru_scan"] == before["rglru_scan"]
    da, dx = scan_ref.rglru_scan_backward_ref(a, h.detach(), g)
    _assert_bitwise(ta.grad, da)
    _assert_bitwise(tx.grad, dx)


@pytest.mark.parametrize("kmax", [1, 2, 3, 5, 38, 131, 4099])
def test_sparsify_bitwise_on_ragged_rows(cuda, kmax):
    """K = 3 rows, kmax = 1, 2, 3 (mod 4) so rows start off the 16-byte
    grid, -1 and out-of-range slots, chosen -0.0, and an index tensor that
    is itself off the grid (a view at a 4-byte offset)."""
    rng = np.random.default_rng(kmax)
    lmax = 5000
    segs = torch.from_numpy(rng.standard_normal((3, lmax)).astype(
        np.float32)).to(cuda)
    segs[:, ::7] = -0.0
    idx = rng.integers(0, lmax, size=(3, kmax)).astype(np.int32)
    idx[0, ::3] = -1
    idx[1, ::5] = lmax                             # out of range
    idx[2, ::2] = 7 * rng.integers(0, lmax // 7, size=idx[2, ::2].shape)
    flat = torch.zeros(3 * kmax + 1, dtype=torch.int32, device=cuda)
    flat[1:] = torch.from_numpy(idx.reshape(-1)).to(cuda)
    for indices in (flat[1:].view(3, kmax), flat[1:].clone().view(3, kmax)):
        before = launch_counts()["compress_sparsify"]
        got = compress_ops.sparsify(segs, indices)
        assert launch_counts()["compress_sparsify"] == before + 1
        _assert_bitwise(got, compress_ref.sparsify_ref(segs, indices))
    want = compress_ref.sparsify_ref(segs, indices)
    assert (_bits(want) == _bits(torch.tensor(-0.0, device=cuda))).any()


def test_sparsify_takes_more_rows_than_one_grid_dimension(cuda):
    """70,000 rows, more than a grid's y dimension holds (65,535): the
    kernel walks the rows past it, bitwise."""
    rng = np.random.default_rng(70000)
    segs = torch.from_numpy(rng.standard_normal((70000, 9)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(-1, 9, size=(70000, 3)).astype(
        np.int32)).to(cuda)
    _assert_bitwise(compress_ops.sparsify(segs, idx),
                    compress_ref.sparsify_ref(segs, idx))


def test_rglru_scan_gradient_equals_the_plain_backward(cuda):
    """The kernel's backward (the reverse kernel over a_{t+1}) bitwise
    against the same gradient from the plain loops on the card, and
    against autograd through the plain forward loop up to the sign of a
    zero: at t = 0, ``da = dh·h_{-1}`` is ``dh·(+0)``, which keeps the sign
    of ``dh``, where autograd sums the per-step slices into +0."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.rand(2, 300, 130, generator=gen, device=cuda) * 0.95 + 0.05
    x = torch.randn(2, 300, 130, generator=gen, device=cuda)
    g = torch.randn(2, 300, 130, generator=gen, device=cuda)
    ta, tx = a.clone().requires_grad_(), x.clone().requires_grad_()
    h = scan_ops.rglru_scan(ta, tx)
    h.backward(g)
    dh = scan_ref.rglru_scan_ref(torch.nn.functional.pad(a[:, 1:],
                                                         (0, 0, 0, 1)),
                                 g, reverse=True)
    h_prev = torch.nn.functional.pad(h.detach()[:, :-1], (0, 0, 1, 0))
    _assert_bitwise(tx.grad, dh)
    _assert_bitwise(ta.grad, dh * h_prev)
    pa, px = a.clone().requires_grad_(), x.clone().requires_grad_()
    scan_ref.rglru_scan_ref(pa, px).backward(g)
    _assert_bitwise(tx.grad, px.grad)
    _assert_bitwise(ta.grad[:, 1:], pa.grad[:, 1:])
    assert torch.equal(ta.grad[:, 0], pa.grad[:, 0])     # all ±0
    assert not pa.grad[:, 0].any()


def _hybrid_smoke():
    """Reduced recurrentgemma-2b with 3 layers, (rglru, rglru, local_attn),
    at seq 80: the reduced window of 64 bites."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig
    arch = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                               num_layers=3)
    return RuntimeConfig(runtime="zero", arch="recurrentgemma-2b",
                         reduced=True, batch=2, seq=80), arch


def test_hybrid_smoke_config_runs_through_the_scan_kernel(cuda):
    from repro_torch.runtime import build_runtime
    config, arch = _hybrid_smoke()
    rt = build_runtime(config, arch)
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
        "flash_attention_fwd": 2 * 2 * 1,
        "compress_quantize": 0, "compress_dequantize": 0,
        "compress_sparsify": 0, "compress_densify": 0,
        "rglru_scan": 2 * 2 * 2, "rglru_scan_bwd": 2 * 2,
        "moe_positions": 0, "adamw": 2 * len(rt.trainer.specs)}


# Card against CPU for the reduced recurrentgemma-2b zero run, 3 steps from
# one initial state: the largest relative loss gap measured on an H100 80GB
# HBM3 (700 W) was 7.8e-8; the bound is ps.json's (5x its largest gap).
HYBRID_CARD_CPU_RTOL = 2e-6


def test_hybrid_smoke_config_on_the_card_matches_the_cpu(cuda, tmp_path):
    from repro_torch.runtime import build_runtime
    config, arch = _hybrid_smoke()
    path = str(tmp_path / "init.npz")
    try:
        cpu_rt = build_runtime(config, arch, device="cpu")
        cpu_rt.save_state(path)
        want = cpu_rt.fit(3)
    finally:
        torch.distributed.destroy_process_group()
    try:
        card_rt = build_runtime(config, arch)
        card_rt.restore_state(path)
        got = card_rt.fit(3)
    finally:
        torch.distributed.destroy_process_group()
    gap = np.max(np.abs(np.subtract(got, want)) / np.abs(want))
    print(f"reduced recurrentgemma-2b: card {got}, CPU {want}, rel gap "
          f"{gap:.3g}")
    assert np.all(np.isfinite(got))
    assert gap <= HYBRID_CARD_CPU_RTOL


def test_measured_costs_come_from_cuda_events(cuda, monkeypatch):
    """On the card each measured fc / bc sample is a pair of CUDA events
    around the call (never the host clock), one pair per call."""
    from repro_torch.configs import get_config
    from repro_torch.core import LayerTimingHook
    from repro_torch.data.pipeline import SyntheticText
    from repro_torch.dist.zero import ZeroTrainer
    from repro_torch.optim import adamw
    from repro_torch.runtime import measure
    from repro_torch.runtime.replan import sequential_plan

    made = []

    class CountedEvent(torch.cuda.Event):
        def __new__(cls, *args, **kwargs):
            made.append(kwargs.get("enable_timing", False))
            return super().__new__(cls, *args, **kwargs)

    def host_clock(*args, **kwargs):
        raise AssertionError("the card's samples must not use the host clock")

    arch = get_config("granite-3-2b").reduced()
    zero = ZeroTrainer(cfg=arch, plan=sequential_plan(arch.num_layers + 2),
                       optimizer=adamw(1e-3), device=cuda)
    try:
        state = zero.init_state(torch.Generator(device=cuda).manual_seed(0))
        batch = SyntheticText(arch.vocab_size, 32, 4, seed=0).batch(0)
        hook = LayerTimingHook(warmup=1)
        monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
        monkeypatch.setattr(hook, "timed", host_clock)
        measure.measure_layer_times(arch, zero, state, batch, hook,
                                    aux_weight=zero.aux_weight,
                                    device=zero.device, iters=2)
    finally:
        torch.distributed.destroy_process_group()
    L = zero.num_layers
    assert made.count(True) == 2 * 3 * 2 * L    # (start, end) x calls
    for phase in ("fc", "bc"):
        for layer in range(L):
            assert hook.num_samples(phase, layer) == 3
        v = hook.median(phase, L)
        assert np.all(np.isfinite(v)) and np.all(v > 0)


def test_block_waits_for_a_tuple(cuda):
    """``_block`` returns only once the work that made every leaf of a
    tuple / list / dict is done."""
    from repro_torch.core.profiler import _block
    x = torch.ones(4, device=cuda)
    for make in (lambda a: (a, a * 2), lambda a: [a, {"k": (a,)}]):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)          # ~0.1 s of device time
        y = x + 1
        done = torch.cuda.Event()
        done.record()
        _block(make(y))
        assert done.query()


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_pinned_pull_keeps_its_bytes_on_the_card(cuda, opt):
    """The server's in-place optimizer on CUDA buffers: a pull pinned at
    version v returns v's bytes after later commits (k = 1)."""
    from repro_torch.dist.collectives import flatten_tree, make_flat_spec
    from repro_torch.optim import adamw, sgd
    from repro_torch.ps import PSServer, PSTopology
    trees = [{"w": torch.arange(700, dtype=torch.float32, device=cuda) + l}
             for l in range(3)]
    specs = [make_flat_spec(t, 1) for t in trees]
    server = PSServer(specs, PSTopology.uniform(2, 2),
                      sgd(0.5) if opt == "sgd" else adamw(0.1),
                      [flatten_tree(t, s) for t, s in zip(trees, specs)],
                      staleness_bound=1)
    for v in range(3):
        before = [f.clone() for f in server.flats()]
        server.push_bucket(0, v, (2, 1, 0), {
            l: torch.full((specs[l].padded,), 1.0 + v, device=cuda)
            for l in range(3)})
        _, pinned = server.pull_bucket((0, 1, 2), version=v)
        _, head = server.pull_bucket((0, 1, 2))
        for l in range(3):
            assert pinned[l].is_cuda and torch.equal(pinned[l], before[l])
            assert not torch.equal(head[l], before[l])
    assert server.snapshot_versions == (2, 3)


def _card_server(cuda, staleness=1):
    """3 layers of 700 on the card behind 2 servers, AdamW 0.1."""
    from repro_torch.dist.collectives import flatten_tree, make_flat_spec
    from repro_torch.optim import adamw
    from repro_torch.ps import PSServer, PSTopology
    trees = [{"w": torch.arange(700, dtype=torch.float32, device=cuda) + l}
             for l in range(3)]
    specs = [make_flat_spec(t, 1) for t in trees]
    server = PSServer(specs, PSTopology.uniform(2, 2), adamw(0.1),
                      [flatten_tree(t, s) for t, s in zip(trees, specs)],
                      staleness_bound=staleness)
    return server, specs


def _commit(server, specs, version, cuda):
    server.push_bucket(0, version, (2, 1, 0), {
        l: torch.full((specs[l].padded,), 1.0 + version, device=cuda)
        for l in range(3)})


def test_reshard_keeps_the_pinned_bytes_on_the_card(cuda):
    """A reshard (3 shards, then 1) moves no CUDA buffer: the head, the
    moments and a pull pinned at the retained snapshot keep their bytes."""
    from repro_torch.ps import PSTopology
    server, specs = _card_server(cuda)
    for v in range(2):
        _commit(server, specs, v, cuda)
    pin = server.version - 1
    _, pinned = server.pull_bucket((0, 1, 2), version=pin)
    pinned = {l: f.clone() for l, f in pinned.items()}
    head = [f.clone() for f in server.flats()]
    mu = [m.clone() for m in server._opt_state.mu]
    for shards in (3, 1):
        server.reshard(PSTopology.uniform(shards, 2))
        _, again = server.pull_bucket((0, 1, 2), version=pin)
        for l in range(3):
            assert again[l].is_cuda and torch.equal(again[l], pinned[l])
            assert torch.equal(server.flats()[l], head[l])
            assert torch.equal(server._opt_state.mu[l], mu[l])
    assert server.ledger.num_reshards == 2


def test_state_dict_of_a_card_server_is_unchanged_by_a_commit(cuda):
    """The state dict is a host value: a later commit on the card moves
    the live buffers and leaves the taken dict as it was."""
    server, specs = _card_server(cuda)
    taken = server.state_dict()
    opt = taken["opt"]
    assert all(not t.is_cuda for t in [*taken["flats"], *opt.mu, *opt.nu,
                                       opt.step])
    before = [t.clone() for t in [*taken["flats"], *opt.mu, *opt.nu]]
    _commit(server, specs, 0, cuda)
    assert int(opt.step) == 0 and int(server._opt_state.step) == 1
    for a, b in zip([*taken["flats"], *opt.mu, *opt.nu], before):
        assert torch.equal(a, b)
    assert not torch.equal(server.flats()[0].cpu(), taken["flats"][0])


def _cnn_async(device, throttle):
    """3 workers, SGD 0.05, k = 1 over the small CNN from one seeded CPU
    draw, on ``device``."""
    from repro_torch.core import plan_from_decision
    from repro_torch.models.cnn import small_cnn_init, small_cnn_loss
    from repro_torch.optim import sgd
    from repro_torch.ps import AsyncPSTrainer, PSTopology, asymmetric_link
    from repro_torch import tree
    params = tree.tree_map(lambda x: x.to(device), small_cnn_init(
        torch.Generator().manual_seed(0)))
    plan = plan_from_decision(((1, 3), (4, 5)), ((4, 5), (1, 3)), 5)
    topo = PSTopology(num_servers=2, links=tuple(
        asymmetric_link(10e9, 1e9) for _ in range(3)),
        worker_flops=(1e10,) * 3)
    return AsyncPSTrainer(
        init_layers=params["layers"],
        loss_fn=lambda ls, b: small_cnn_loss({"layers": ls}, b["images"],
                                             b["labels"]),
        optimizer=sgd(0.05), topology=topo, plan=plan, staleness=1,
        throttle=throttle)


@pytest.mark.parametrize("throttle", ["reject", "wait"])
def test_async_cnn_on_the_card_matches_the_cpu(cuda, throttle):
    """The same event sequence exactly, the losses to the card-against-CPU
    tolerance (cuDNN in its deterministic mode)."""
    from repro_torch.data import SyntheticCIFAR
    batch = SyntheticCIFAR(8, seed=7).batch(0)
    logs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for device in ("cpu", cuda):
            logs.append(_cnn_async(device, throttle).run(
                12, lambda w, i: batch))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    cpu, card = logs
    trace = [[(e.worker, e.sim_time, e.version, e.result.accepted,
               e.result.staleness, e.retries, e.wait_s) for e in log.events]
             for log in logs]
    assert trace[0] == trace[1]
    gap = np.max(np.abs(np.subtract(card.losses, cpu.losses)) /
                 np.abs(cpu.losses))
    print(f"async CNN/{throttle}: rel gap {gap:.3g}")
    assert gap <= CARD_CPU_RTOL


def _pipeline_smoke():
    from repro_torch.runtime import RuntimeConfig
    return RuntimeConfig.load(os.path.join(ROOT, "examples",
                                           "runtime_configs", "pipeline.json"))


def test_pipeline_smoke_config_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``pipeline.json`` from one initial state: the CPU's losses within
    the card-against-CPU tolerance, and flash launched 3 times per
    attention block and micro-batch a step (the forward, the stage's
    recompute and the VJP's recompute); no other kernel of the port."""
    from repro_torch.runtime import build_runtime
    config = _pipeline_smoke()
    path = str(tmp_path / "init.npz")
    cpu_rt = build_runtime(config, device="cpu")
    cpu_rt.save_state(path)
    want = cpu_rt.fit(3)
    card_rt = build_runtime(config)
    card_rt.restore_state(path)
    assert card_rt.trainer.device.type == "cuda"
    reset_launch_counts()
    got = card_rt.fit(3)
    counts = launch_counts()
    gap = np.max(np.abs(np.subtract(got, want)) / np.abs(want))
    print(f"pipeline.json: card {got}, CPU {want}, rel gap {gap:.3g}")
    assert gap <= CARD_CPU_RTOL
    flash = 3 * 3 * card_rt.arch.num_layers * config.pipeline.microbatches
    assert counts.pop("flash_attention_fwd") == flash
    assert counts.pop("adamw") == 3 * len(card_rt.trainer.specs)
    assert not any(counts.values()), counts
    assert not torch.distributed.is_initialized()


def test_pipeline_stage_devices_on_one_card_are_bitwise_none(cuda):
    from repro_torch.pipeline import PipelineTrainer
    from repro_torch.runtime import build_runtime
    config = _pipeline_smoke()
    rt = build_runtime(config)
    batch = rt._batch_fn(0)
    runs = []
    for devices in (None, [cuda] * config.pipeline.stages):
        tr = PipelineTrainer(
            cfg=rt.arch, optimizer=config.build_optimizer(), device=cuda,
            num_stages=config.pipeline.stages,
            num_microbatches=config.pipeline.microbatches,
            partition=rt.partition, stage_devices=devices)
        state = tr.init_state(torch.Generator(device=cuda).manual_seed(0))
        losses = []
        for _ in range(2):
            state, loss = tr.step(state, batch)
            losses.append(float(loss))
        runs.append((losses, state["flat_params"]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        _assert_bitwise(a, b)


def test_verify_runtime_on_the_card_and_recording_never_syncs(cuda):
    """Reduced ``zero.json`` verified on the card (one NCCL rank): no
    finding.  Then the bucket collectives and an all-reduce on card
    tensors, recorded under ``set_sync_debug_mode("error")`` (warmed up
    first, so the NCCL communicator exists): the recorder reads sizes
    only, and nothing in the window waits for the stream."""
    from repro_torch.analysis import record_collectives
    from repro_torch.analysis.runtime_verify import verify_runtime
    from repro_torch.dist.collectives import (gather_bucket, make_flat_spec,
                                              reduce_scatter_bucket)
    from repro_torch.runtime import RuntimeConfig
    try:
        findings, info = verify_runtime(RuntimeConfig.load(os.path.join(
            ROOT, "examples", "runtime_configs", "zero.json")))
        assert findings == [], [f.format() for f in findings]
        assert info["steps_run"] == 1
        specs = [make_flat_spec({"w": torch.empty(s)}, 1)
                 for s in ((300, 7), (5,))]
        shards = [torch.randn(s.shard_size, device=cuda) for s in specs]
        grads = {0: {"w": torch.randn(300, 7, device=cuda)},
                 1: {"w": torch.randn(5, device=cuda)}}

        def calls():
            gather_bucket(shards, specs, (0, 1))
            reduce_scatter_bucket(grads, specs, (1, 0))
            torch.distributed.all_reduce(shards[1])

        calls()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with record_collectives() as trace:
                calls()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert [(r.kind, r.bytes, r.group_size) for r in trace] == [
            ("all-gather", 4 * 2105, 1), ("reduce-scatter", 4 * 2105, 1),
            ("all-reduce", 20, 1)]
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the MoE MLP on the card
# ---------------------------------------------------------------------------

# chip_smoke.py holds the dropping config, the gradient limit and the aux
# witness that the card tests share with it
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


def _moe_config(**changes):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                               **dict(SMOKE.MOE_DROPPING, **changes))


def _close_to_scale(got, want):
    assert SMOKE.leaf_gap(got.cpu(), want.cpu()) <= SMOKE.GRAD_SCALE_RTOL


def test_moe_block_on_the_card_matches_the_cpu(cuda):
    """One MoE block on the card against the CPU on the same weights and
    input: the routing integers equal, the output, aux and every VJP leaf
    to fp32 roundoff of its scale."""
    from repro_torch import tree
    from repro_torch.models import blocks, moe
    cfg = _moe_config()
    params = blocks.init_block(torch.Generator().manual_seed(0), cfg,
                               "global_attn", mlp="moe")
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    runs = []
    for dev in ("cpu", cuda):
        p = tree.tree_map(lambda t: t.to(dev).requires_grad_(), params)
        h = x.to(dev).requires_grad_()
        y, _, aux = blocks.apply_block(p, h, cfg, "global_attn",
                                       mode="train")
        grads = torch.autograd.grad(
            [y, aux], tree.leaves(p) + [h],
            grad_outputs=[ct.to(dev), torch.full((), 0.01, device=dev)])
        probs = torch.softmax(h.detach().reshape(-1, cfg.d_model)
                              @ p["moe"]["router"].detach(), dim=-1)
        r = moe.route(probs, cfg, moe.expert_capacity(128, cfg))
        runs.append((y.detach(), aux.detach(), grads, r))
    (y0, a0, g0, r0), (y1, a1, g1, r1) = runs
    assert not r0.keep.all()
    for a, b in zip(r0[1:], r1[1:]):
        assert torch.equal(a, b.cpu())
    _close_to_scale(y1, y0)
    assert abs(a1.item() - a0.item()) <= 1e-6 * abs(a0.item())
    for a, b in zip(g1, g0):
        _close_to_scale(a, b)


def test_moe_dispatch_is_bitwise_from_run_to_run(cuda):
    """The scatter's forward and the gather's backward add through atomics
    on the card; every extra contribution to a slot is an exact zero, so
    two runs give the same bits.  One full-width MoE MLP (32 experts of
    d_ff 512, top-8, 2048 tokens: capacity 640) and a dropping one."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    full = get_config("granite-moe-1b-a400m")
    for cfg in (full, dataclasses.replace(full, capacity_factor=0.5)):
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = moe.init_moe_params(gen, cfg, device=cuda)
        x = torch.randn(2, 1024, cfg.d_model, generator=gen, device=cuda)
        ct = torch.randn(x.shape, generator=gen, device=cuda)
        runs = []
        for _ in range(2):
            p = tree.tree_map(lambda t: t.detach().requires_grad_(), params)
            h = x.detach().requires_grad_()
            out, aux = moe.apply_moe(p, h, cfg)
            grads = torch.autograd.grad(
                [out, aux], tree.leaves(p) + [h],
                grad_outputs=[ct, torch.full((), 0.01, device=cuda)])
            runs.append([out.detach(), aux.detach(), *grads])
        for a, b in zip(*runs):
            _assert_bitwise(a, b)


def _routed(cuda, tokens, e, k, skew, seed=0):
    """The expert ids of ``tokens`` tokens routed top-``k`` of ``e`` (each
    token's k distinct experts, best first), from uniform scores less
    ``skew`` times a ramp over the experts: skew > 0 crowds the low
    experts past their capacity."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ramp = torch.arange(e, device=cuda, dtype=torch.float32) / e
    scores = torch.rand(tokens, e, generator=gen, device=cuda) - skew * ramp
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True)[1][:, :k].reshape(-1)


def _position_case(case, cuda):
    """``(flat_e, E, first, held, cap)`` of a case: the MoE cells' shapes
    at their capacities, grok's E = 8, a decode step, a length past a
    whole tile, every assignment on one expert, a capacity above every
    count."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    def at(name, tokens, first=0, held=None, skew=1.0):
        cfg = get_config(name)
        e, k = cfg.num_experts, cfg.top_k
        return (_routed(cuda, tokens, e, k, skew), e, first,
                e if held is None else held,
                moe.expert_capacity(tokens, cfg))
    if case == "one-expert":
        return torch.full((5000,), 3, dtype=torch.int64, device=cuda), \
            8, 0, 8, 100
    if case == "cap-above-every-count":
        flat_e, e, first, held, _ = at("granite-moe-1b-a400m", 2048)
        return flat_e, e, first, held, flat_e.numel() + 1
    return {"granite-moe-1b-a400m": lambda: at("granite-moe-1b-a400m", 2048),
            "granite-4.0-h-small": lambda: at("granite-4.0-h-small", 4096,
                                              held=8),
            "grok-1-314b": lambda: at("grok-1-314b", 2048),
            "decode": lambda: at("granite-moe-1b-a400m", 8, skew=0.0),
            "ragged": lambda: at("granite-moe-1b-a400m", 1025, first=5,
                                 held=20)}[case]()


@pytest.mark.parametrize("case", [
    "granite-moe-1b-a400m",      # cell B: (16,384, E = 32)
    "granite-4.0-h-small",       # cell E: (40,960, E = 72), 0-7 held
    "grok-1-314b", "decode", "ragged", "one-expert",
    "cap-above-every-count"])
def test_moe_positions_bitwise_vs_plain(cuda, case):
    """One launch, whose slot and keep equal the one-hot cumulative sum's
    bitwise."""
    flat_e, e, first, held, cap = _position_case(case, cuda)
    before = launch_counts()["moe_positions"]
    slot, keep = positions_ops.moe_positions(flat_e, e, first, held, cap)
    assert launch_counts()["moe_positions"] == before + 1
    want_slot, want_keep = positions_ref.moe_positions_ref(flat_e, e, first,
                                                           held, cap)
    assert slot.dtype == torch.int64 and keep.dtype == torch.bool
    assert torch.equal(slot, want_slot) and torch.equal(keep, want_keep)
    if case in ("granite-moe-1b-a400m", "granite-4.0-h-small", "ragged"):
        assert keep.any() and not keep.all()     # kept and dropped alike
    if case == "one-expert":
        assert int(keep.sum()) == cap
    if case == "cap-above-every-count":
        assert keep.all()


def test_route_on_the_card_launches_the_position_kernel_once(cuda):
    """``route`` on a CUDA tensor: one launch, the CPU's integers."""
    from repro_torch.models import moe
    cfg = _moe_config()
    probs = torch.softmax(torch.randn(
        256, cfg.num_experts, generator=torch.Generator().manual_seed(0)),
        dim=-1)
    cap = moe.expert_capacity(256, cfg)
    before = launch_counts()["moe_positions"]
    got = moe.route(probs.to(cuda), cfg, cap)
    assert launch_counts()["moe_positions"] == before + 1
    want = moe.route(probs, cfg, cap)
    assert not want.keep.all()
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)


def test_moe_zero_steps_launch_the_position_kernel_twice_a_layer(cuda):
    """Reduced granite-moe under ``zero``, 2 steps: the position kernel
    once a layer in the forward and once in the recompute."""
    from repro_torch.runtime import RuntimeConfig, build_runtime
    arch = _moe_config()
    rt = build_runtime(RuntimeConfig(runtime="zero",
                                     arch="granite-moe-1b-a400m",
                                     reduced=True, batch=2, seq=64), arch)
    reset_launch_counts()
    try:
        losses = rt.fit(2)
    finally:
        torch.distributed.destroy_process_group()
    assert np.all(np.isfinite(losses))
    assert launch_counts()["moe_positions"] == 2 * 2 * arch.num_layers


def test_moe_aux_witness_at_two_blocks(cuda):
    """``chip_smoke.moe_aux_witness`` on the reduced dropping MoE: the ZeRO
    step's gradients on the card (recorded by the optimizer) equal
    ``torch.autograd`` of ``train_loss``, each leaf within GRAD_SCALE_RTOL
    of its largest magnitude; at ``aux_weight = 0`` the router's gradient
    moves by more than twice that."""
    try:
        out = SMOKE.moe_aux_witness(_moe_config(), cuda, seq=64, batch=2)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert out["worst"] <= SMOKE.GRAD_SCALE_RTOL
    assert out["moved"] > 2 * SMOKE.GRAD_SCALE_RTOL


def test_mlstm_forms_agree_on_the_card(cuda):
    """``chip_smoke.mlstm_forms_on_the_card``: the parallel form against the
    chunkwise form at the full-width block's (2, 4, 256, 512)."""
    assert SMOKE.mlstm_forms_on_the_card(cuda) <= SMOKE.MLSTM_FORMS_ATOL


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_on_the_card_matches_the_cpu(cuda, kind):
    """One xLSTM block (reduced width, T = 320: the mLSTM's chunkwise form
    at chunk 64) on the card against the CPU on the same weights and
    input: the output and every VJP leaf within 1e-4 of its largest
    magnitude (``tests/test_torch_xlstm.py``'s bound)."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(),
                              num_layers=8)
    params = blocks.init_block(torch.Generator().manual_seed(0), cfg, kind,
                               mlp="none")
    x = torch.randn(2, 320, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    runs = []
    for dev in ("cpu", cuda):
        p = tree.tree_map(lambda t: t.to(dev).requires_grad_(), params)
        h = x.to(dev).requires_grad_()
        y, _, _ = blocks.apply_block(p, h, cfg, kind, mode="train")
        grads = torch.autograd.grad(y, tree.leaves(p) + [h], ct.to(dev))
        runs.append([y.detach(), *grads])
    for a, b in zip(runs[1], runs[0]):
        assert SMOKE.leaf_gap(a.cpu(), b) <= 1e-4


@pytest.mark.parametrize("arch", ["xlstm-350m", "hubert-xlarge",
                                  "llava-next-34b"])
def test_family_zero_on_the_card_matches_the_cpu(cuda, arch):
    """Reduced xlstm (8 layers: one sLSTM block), hubert and llava under
    ``zero.json`` with SGD (``chip_smoke.WITNESS_LR``): the card against
    the port on the CPU from one initial state, losses to rtol 1e-5 (xlstm
    over 2 steps: its trajectories part at the third even between float32
    and float64, ``tests/test_torch_xlstm.py``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.runtime import RuntimeConfig
    model = get_config(arch).reduced()
    if arch == "xlstm-350m":
        model = dataclasses.replace(model, num_layers=8)
    config = dataclasses.replace(RuntimeConfig.load(os.path.join(
        ROOT, "examples", "runtime_configs", "zero.json")), optimizer="sgd",
        lr=SMOKE.WITNESS_LR, seq=48)
    try:
        gap, card, cpu = SMOKE.card_against_cpu(
            config, model, steps=2 if arch == "xlstm-350m" else SMOKE.STEPS)
    finally:
        SMOKE.drop_group()
    assert np.all(np.isfinite(card))
    assert gap <= SMOKE.LOSS_RTOL, (card, cpu)


# ---------------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------------


def _serve_setup(dev):
    """Reduced recurrentgemma-2b with one block of each kind the served
    models decode through a cache (RG-LRU, local and global attention;
    window 64), its parameters and a 70-token prompt past the window."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(
        get_config("recurrentgemma-2b").reduced(num_layers=3),
        layer_pattern=("rglru", "local_attn", "global_attn"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 70), dtype=np.int32)).to(dev)
    return cfg, params, prompts


def test_decode_steps_never_synchronise(cuda):
    """4 decode steps under ``set_sync_debug_mode("error")``: the slot,
    key positions and bias come from the device ``pos``, the rope table is
    uploaded once, the next token is the device argmax."""
    from repro_torch.models import model
    from repro_torch.serve import decode as serve
    cfg, params, prompts = _serve_setup(cuda)
    with torch.inference_mode():
        logits, caches = serve.prefill(cfg, params, {"tokens": prompts},
                                       max_len=74)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(4):
                logits, caches = model.decode_step(cfg, params, tok, caches)
                tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert [int(c.pos) for c in caches[1:]] == [74, 74]
    assert bool(torch.isfinite(logits).all())


def _graph_events(monkeypatch):
    """What ``serve/graphs.py`` counts (captures, replays), counted here
    whether or not a profiler records, from an empty graph store (a freed
    parameter's address may come back, and with it an earlier test's
    key)."""
    import collections
    from repro_torch import tracing
    from repro_torch.serve import graphs
    graphs._store.clear()
    seen = collections.Counter()
    monkeypatch.setattr(tracing, "count",
                        lambda name, value: seen.update({name: value}))
    return seen


def test_batched_generate_never_synchronises(cuda, monkeypatch):
    """The whole generate loop, prefill included (flash, the scan, the
    local cache's roll), under ``set_sync_debug_mode("error")`` after a
    first run has built the kernels and captured the decode step's graph;
    the second call replays it, and gives the same tokens as the first."""
    from repro_torch.serve import batched_generate
    cfg, params, prompts = _serve_setup(cuda)
    seen = _graph_events(monkeypatch)
    first = batched_generate(cfg, params, prompts, max_new_tokens=6)
    torch.cuda.synchronize()
    seen.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = batched_generate(cfg, params, prompts, max_new_tokens=6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again)
    assert seen == {"serve.graph_replays": 6}


# every family that decodes: dense, MoE, local windows with softcaps, the
# RG-LRU with local and global attention, the mLSTM and sLSTM
GRAPHED = ["granite-3-2b", "granite-moe-1b-a400m", "gemma2-2b",
           "recurrentgemma-2b", "xlstm-350m"]


def _served_model(name, dev, seed=0):
    """Reduced ``name`` and its parameters; recurrentgemma-2b is
    ``_serve_setup``'s three block kinds, xlstm-350m 8 layers (one
    sLSTM)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    if name == "recurrentgemma-2b":
        cfg = _serve_setup(dev)[0]
    else:
        cfg = get_config(name).reduced(
            **({"num_layers": 8} if name == "xlstm-350m" else {}))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    return cfg, params


def _served_prompts(cfg, b, t, dev, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t), dtype=np.int32)).to(dev)


def _serve_runs(cfg, params, dev, lengths=(70, 33), new=6):
    """``batched_generate`` greedy, then sampled from a generator seeded
    2, at each prompt length: each call's tokens and the logits its hook
    saw."""
    from repro_torch.serve import batched_generate
    runs = []
    for t in lengths:
        for greedy in (True, False):
            seen = []
            out = batched_generate(
                cfg, params, _served_prompts(cfg, 2, t, dev),
                max_new_tokens=new, greedy=greedy,
                generator=torch.Generator(device=dev).manual_seed(2),
                on_step=lambda i, logits, caches: seen.append(logits))
            runs.append((out, torch.stack(seen)))
    return runs


def _eager(monkeypatch, fn):
    """``fn()`` with the graph path off: the eager loop on the card."""
    from repro_torch.serve import graphs
    with monkeypatch.context() as m:
        m.setattr(graphs, "lookup", lambda *a, **k: None)
        return fn()


@pytest.mark.parametrize("name", GRAPHED)
def test_graphed_decode_is_bitwise_the_eager_loop(cuda, monkeypatch, name):
    """Greedy and sampled, at two prompt lengths (past and inside the
    local window): the tokens and the hook's logits of the graph path are
    the eager loop's bit for bit.  Each length's first call captures on
    its second step, the sampled call after it replays the stored graph
    from its first; a hook's logits are not overwritten by later steps."""
    from repro_torch.serve import graphs
    cfg, params = _served_model(name, cuda)
    seen = _graph_events(monkeypatch)
    graphed = _serve_runs(cfg, params, cuda)
    assert seen == {"serve.graph_captures": 2,
                    "serve.graph_replays": 2 * 5 + 2 * 6}
    assert sum(g.graph is not None for g in graphs._store.values()) >= 2
    eager = _eager(monkeypatch, lambda: _serve_runs(cfg, params, cuda))
    for (out, logits), (want, want_logits) in zip(graphed, eager):
        assert torch.equal(out, want), name
        assert torch.equal(logits, want_logits), name


def test_a_new_parameter_leaf_recaptures(cuda, monkeypatch):
    """A graph reads its parameters by address: a new dict, or the same
    dict's leaves with one replaced, is a new key that captures anew, and
    its tokens follow the new parameters (the eager loop's on them)."""
    from repro_torch import tree
    from repro_torch.serve import batched_generate
    cfg, a = _served_model("granite-3-2b", cuda)
    _, b = _served_model("granite-3-2b", cuda, seed=5)
    c = tree.tree_map(lambda x: x, a)
    c["final"]["norm"] = a["final"]["norm"] + 0.5
    prompts = _served_prompts(cfg, 2, 40, cuda)

    def serve(params):
        return batched_generate(cfg, params, prompts, max_new_tokens=5)

    seen = _graph_events(monkeypatch)
    for i, params in enumerate((a, b, c), start=1):
        got = serve(params)
        assert seen["serve.graph_captures"] == i
        assert torch.equal(got, _eager(monkeypatch, lambda: serve(params)))
    serve(a)                                      # its key is still held
    assert seen["serve.graph_captures"] == 3


def test_the_graph_store_keeps_its_bound(cuda, monkeypatch):
    """More cache lengths than ``MAX_GRAPHS``: the store never holds more,
    it drops the key used longest ago, and a dropped key captures again."""
    from repro_torch.serve import batched_generate, graphs
    cfg, params = _served_model("granite-3-2b", cuda)
    seen = _graph_events(monkeypatch)
    lengths = [20 + i for i in range(graphs.MAX_GRAPHS + 2)]
    for t in lengths:
        batched_generate(cfg, params, _served_prompts(cfg, 2, t, cuda),
                         max_new_tokens=3)
        assert len(graphs._store) <= graphs.MAX_GRAPHS
    assert seen["serve.graph_captures"] == len(lengths)
    batched_generate(cfg, params, _served_prompts(cfg, 2, lengths[-1], cuda),
                     max_new_tokens=3)
    assert seen["serve.graph_captures"] == len(lengths)
    batched_generate(cfg, params, _served_prompts(cfg, 2, lengths[0], cuda),
                     max_new_tokens=3)
    assert seen["serve.graph_captures"] == len(lengths) + 1


def test_a_single_step_call_never_captures(cuda, monkeypatch):
    """One decode step on a key without a graph stays eager and stores
    nothing; on a key with one (the cache length, not the prompt's, is
    the key's) it replays."""
    from repro_torch.serve import batched_generate, graphs
    cfg, params = _served_model("granite-3-2b", cuda, seed=7)
    prompts = _served_prompts(cfg, 2, 30, cuda)
    seen = _graph_events(monkeypatch)

    def one():
        return batched_generate(cfg, params, prompts, max_new_tokens=1)

    got = one()
    assert seen == {} and len(graphs._store) == 0
    batched_generate(cfg, params, prompts[:, 1:], max_new_tokens=2)
    assert seen == {"serve.graph_captures": 1, "serve.graph_replays": 1}
    again = one()
    assert seen["serve.graph_replays"] == 2
    want = _eager(monkeypatch, one)
    assert torch.equal(got, want) and torch.equal(again, want)


def test_a_replayed_decode_step_makes_few_host_launches(cuda):
    """Under the profiler, two replayed calls of one prompt length that
    differ by 8 decode steps: the difference in host launches (kernel,
    memcpy, memset and graph launches, as the benchmark counts them) is
    at most 10 a step: the token's copy, the graph, the argmax and its
    cast."""
    import re
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import batched_generate
    launch = re.compile(r"LaunchKernel|cuLaunch|Memcpy|Memset|GraphLaunch")
    cfg, params = _served_model("granite-3-2b", cuda)
    prompts = _served_prompts(cfg, 2, 40, cuda)

    def launches(new):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            batched_generate(cfg, params, prompts, max_new_tokens=new)
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if launch.search(e.name)
                   and e.device_type == torch.autograd.DeviceType.CPU)

    for new in (4, 12):                           # capture both keys
        batched_generate(cfg, params, prompts, max_new_tokens=new)
    per_step = (launches(12) - launches(4)) / 8
    assert 0 < per_step <= 10, per_step


def test_a_graph_captured_under_the_profiler(cuda):
    """The MoE, whose router counts under the profiler: a key captured
    while the profiler records gives the eager loop's tokens, counts one
    capture and a replay for every later step, and its router counted the
    prefill and the eager first step only (nothing of tracing is
    captured)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    from repro_torch.serve import batched_generate, graphs
    cfg, params = _served_model("granite-moe-1b-a400m", cuda, seed=3)
    b, t, new = 2, 24, 5
    prompts = _served_prompts(cfg, b, t, cuda)
    graphs._store.clear()
    tracing.reset_counters()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            got = batched_generate(cfg, params, prompts,
                                   max_new_tokens=new)
            torch.cuda.synchronize()
        c = tracing.counters()
    finally:
        tracing.reset_counters()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(graphs, "lookup", lambda *a, **k: None)
        want = batched_generate(cfg, params, prompts, max_new_tokens=new)
    assert torch.equal(got, want)
    assert c["serve.graph_captures"] == 1
    assert c["serve.graph_replays"] == new - 1
    assert c["moe.assignments"] == cfg.num_layers * cfg.top_k * b * (t + 1)


def test_serve_launcher_runs_on_the_card_by_default(cuda, capsys):
    from repro_torch.launch import serve as launcher
    reset_launch_counts()
    run = launcher.main(["--arch", "recurrentgemma-2b", "--reduced",
                         "--requests", "2", "--prompt-len", "80",
                         "--tokens", "4", "--greedy"])
    assert run["tokens"].is_cuda and run["peak_bytes"] > 0
    assert "peak" in capsys.readouterr().out
    # reduced: 2 RG-LRU blocks, each one scan launch in the prefill
    assert launch_counts()["rglru_scan"] == 2


@pytest.mark.parametrize("name,prompt,total", SMOKE.SERVE_CARD_CPU)
def test_reduced_serving_on_the_card_matches_the_cpu(cuda, name, prompt,
                                                     total):
    """``chip_smoke.serve_card_against_cpu``: logits within
    ``SERVE_CARD_CPU_ATOL`` at every step, tokens where clear of a tie."""
    gap = SMOKE.serve_card_against_cpu(name, prompt, total, cuda)
    assert gap <= SMOKE.SERVE_CARD_CPU_ATOL


def _flash_only(n, adamw=0):
    counts = launch_counts()
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=n, adamw=adamw)
    assert counts == want


def test_stacked_step_on_the_card_equals_the_unrolled_step(cuda):
    """Reduced granite-3-2b (4 layers, T = 64): ``train_loss_scanned`` and
    its unstacked gradients bitwise the unrolled step with per-block remat
    at remat off, per group and two-level (``remat_sqrt=2``); flash once a
    block and once more a level of remat, less one a chunk: a chunk's
    recompute stops at its last group's input (``chip_smoke.
    sqrt_remat_flash``; phase ``loop`` at full width)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticText
    from repro_torch.models import init_params, model, scanned
    cfg = get_config("granite-3-2b").reduced(num_layers=4)
    sp = scanned.stack_layer_params(cfg, init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), torch.float32,
        cuda))
    stacked = [x.requires_grad_() for x in tree.leaves(sp)]
    unrolled = tree.tree_map(lambda x: x.detach().requires_grad_(),
                             scanned.unstack_layer_params(cfg, sp))
    batch = {k: v.to(cuda) for k, v in
             SyntheticText(cfg.vocab_size, 64, 2, seed=0).batch(0).items()}
    reset_launch_counts()
    u_loss = model.train_loss(cfg, unrolled, batch, remat=True)
    u_grads = torch.autograd.grad(u_loss, tree.leaves(unrolled))
    _flash_only(8)
    for kw, flash in ((dict(remat=False), 4), (dict(remat=True), 8),
                      (dict(remat=True, remat_sqrt=2),
                       SMOKE.sqrt_remat_flash(4, 2))):
        reset_launch_counts()
        loss = scanned.train_loss_scanned(cfg, sp, batch, **kw)
        grads = torch.autograd.grad(loss, stacked)
        _flash_only(flash)
        assert torch.equal(loss.view(torch.int32), u_loss.view(torch.int32))
        per_layer = tree.leaves(scanned.unstack_layer_params(
            cfg, tree.unflatten(tree.structure(sp), list(grads))))
        for a, b in zip(per_layer, u_grads):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), kw


def test_stacked_hybrid_forward_on_the_card_is_bitwise(cuda):
    """Reduced recurrentgemma-2b (4 layers: one group of 3 and a remainder
    RG-LRU block) on the stacked layout: logits bitwise ``forward``'s,
    through the scan kernel and flash at hd 64."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticText
    from repro_torch.models import init_params, model, scanned
    cfg = get_config("recurrentgemma-2b").reduced(num_layers=4)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         torch.float32, cuda)
    sp = scanned.stack_layer_params(cfg, params)
    batch = {k: v.to(cuda) for k, v in
             SyntheticText(cfg.vocab_size, 96, 2, seed=0).batch(0).items()}
    with torch.no_grad():
        reset_launch_counts()
        got, _, _ = scanned.forward_scanned(cfg, sp, batch, remat=False)
        counts = launch_counts()
        want, _, _ = model.forward(cfg, params, batch)
    assert (counts["rglru_scan"], counts["flash_attention_fwd"]) == (3, 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_train_loop_on_the_card(cuda, capsys):
    """``TrainLoop`` draws its weights on the generator's device (the
    card) and its losses equal ``build_train_step`` driven by hand."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticText
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import TrainLoop, build_train_step
    cfg = get_config("granite-3-2b").reduced()
    pipe = SyntheticText(cfg.vocab_size, 64, 2, seed=0)
    reset_launch_counts()
    params, _, losses = TrainLoop(cfg=cfg, optimizer=adamw(3e-4),
                                  log_every=1).run(
        torch.Generator(device=cuda).manual_seed(0), iter(pipe), 3)
    _flash_only(3 * cfg.num_layers, 3 * len(tree.leaves(params)))
    assert all(x.is_cuda for x in tree.leaves(params))
    assert len(capsys.readouterr().out.splitlines()) == 3
    p = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                    torch.float32, cuda)
    leaves = [x.requires_grad_() for x in tree.leaves(p)]
    opt = adamw(3e-4)
    state, step = opt.init(leaves), build_train_step(cfg, opt, remat=False)
    by_hand = []
    for i in range(3):
        p, state, loss = step(p, state, {k: v.to(cuda) for k, v in
                                         pipe.batch(i).items()})
        by_hand.append(float(loss))
    assert losses == by_hand


# ---------------------------------------------------------------------------
# the examples on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["serving", "edge_training"])
def test_examples_on_the_card_print_the_cpu_text(cuda, name):
    """``chip_smoke.example_twin``: ``examples/torch_<name>.py`` at its
    tests' small flags with no ``--device`` (the card, drawing on the
    host) and with ``--device cpu`` print the same text once masked, and
    their losses and served prefill logits agree; the card's kernels
    launched as the path asks — reduced gemma2-2b's prefill one flash a
    block and its decode none; edge_training's 6 ZeRO steps under its
    1 / 1 bucket plan a pack a bucket, an unpack a pull bucket, 2 flash
    a block and an AdamW update a sched layer's buffer (4) a step."""
    out = SMOKE.example_twin(name)
    counts = out["counts"]
    want = {k: 0 for k in counts}
    if name == "serving":
        want["flash_attention_fwd"] = 2
        assert out["logits"] <= SMOKE.SERVE_CARD_CPU_ATOL
    else:
        want.update(bucket_pack=12, bucket_unpack=6, flash_attention_fwd=24,
                    adamw=24)
        assert out["losses"] >= 6 and out["fits"] <= SMOKE.CARD_CPU_RTOL
    assert counts == want


def test_host_draws_give_the_cpu_weights_on_the_card(cuda):
    """``torch_examples.host_draws``: a runtime's weights and a sampler's
    draws on the card are the CPU's, bitwise; outside it they are not."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    ex = SMOKE.examples_support()
    cfg = get_config("gemma2-2b").reduced()

    def draws(device):
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, gen, device=device)
        leaves = [x.cpu() for x in torch.utils._pytree.tree_leaves(params)]
        return leaves + [torch.rand((4, 7), generator=gen,
                                    device=device).cpu()]
    cpu = draws("cpu")
    with ex.host_draws():
        card = draws(cuda)
    assert all(torch.equal(a, b) for a, b in zip(card, cpu))
    assert not all(torch.equal(a, b) for a, b in zip(draws(cuda), cpu))
