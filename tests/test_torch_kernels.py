"""The port's kernel modules against the JAX package's (on the CPU).

Pack / unpack are held bitwise; attention to the reference's own
tolerances (``tests/test_kernels.py``: atol 2e-6 in f32, 2e-2 in bf16).
On the CPU every wrapper takes its plain version, so these tests hold the
plain versions and the wrappers' shape logic; the CUDA kernels themselves
are held against the same plain versions by ``test_torch_gpu.py`` and by
``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bucket_pack import ops as jax_pack_ops
from repro.kernels.bucket_pack import ref as jax_pack_ref
from repro.kernels.flash_attention import ops as jax_flash_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels import launch_counts
from repro_torch.kernels.bucket_pack import ops, ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

LENGTHS = [(512,), (512, 1024), (2048, 512, 512, 1024), (512,) * 7]
DTYPES = [(np.float32, torch.float32, jnp.float32),
          ("bf16", torch.bfloat16, jnp.bfloat16)]


def _vectors(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for n in lengths]


def _as_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _as_jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


class TestBucketPack:
    @pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
    @pytest.mark.parametrize("lengths", LENGTHS + [(100, 700, 513)])
    def test_ref_and_wrapper_bitwise_vs_jax(self, lengths, dt):
        _, tdt, jdt = dt
        vecs = _vectors(lengths)
        segs, alens = ops.pad_segments([_as_torch(v, tdt) for v in vecs])
        jsegs, jalens = jax_pack_ops.pad_segments([_as_jax(v, jdt)
                                                   for v in vecs])
        assert alens == jalens
        np.testing.assert_array_equal(_np(segs), _np(jsegs))
        want = jax_pack_ref.bucket_pack_ref(jsegs, jalens)
        np.testing.assert_array_equal(_np(ref.bucket_pack_ref(segs, alens)),
                                      _np(want))
        flat = ops.bucket_pack(segs, alens)
        np.testing.assert_array_equal(
            _np(flat), _np(jax_pack_ops.bucket_pack(jsegs, jalens,
                                                    interpret=True)))
        lmax = segs.shape[1]
        back = ops.bucket_unpack(flat, alens, lmax)
        np.testing.assert_array_equal(
            _np(back), _np(jax_pack_ref.bucket_unpack_ref(want, jalens,
                                                          lmax)))
        np.testing.assert_array_equal(
            _np(back), _np(jax_pack_ops.bucket_unpack(want, jalens, lmax,
                                                      interpret=True)))

    @pytest.mark.parametrize("call,args,match", [
        ("pack", ((2, 100), (512, 512)), "multiple of"),
        ("pack", ((2, 512), (512,)), "aligned lengths"),
        ("pack", ((2, 512), (512, 100)), "positive multiples"),
        ("pack", ((512,), (512,)), "must be \\(K, Lmax\\)"),
        ("unpack", (1024, (512, 512), 100), "multiple of"),
        ("unpack", (512, (512, 512), 512), "flat buffer shape"),
    ])
    def test_value_errors_match_reference(self, call, args, match):
        """The same inputs raise the same ValueError in both packages."""
        from repro.kernels.bucket_pack.bucket_pack import (pack_pallas,
                                                           unpack_pallas)
        if call == "pack":
            shape, alens = args
            with pytest.raises(ValueError, match=match) as mine:
                ops.bucket_pack(torch.ones(shape), alens)
            with pytest.raises(ValueError, match=match) as theirs:
                pack_pallas(jnp.ones(shape), alens)
        else:
            n, alens, lmax = args
            with pytest.raises(ValueError, match=match) as mine:
                ops.bucket_unpack(torch.ones(n), alens, lmax)
            with pytest.raises(ValueError, match=match) as theirs:
                unpack_pallas(jnp.ones(n), alens, lmax)
        assert str(mine.value) == str(theirs.value)

    def test_lengths_past_the_row_raise(self):
        """The reference returns uninitialised values here (it checks only
        the TILE multiple); the port refuses."""
        with pytest.raises(ValueError, match="exceed the row length"):
            ops.bucket_pack(torch.ones(2, 512), (1024, 512))
        with pytest.raises(ValueError, match="exceed lmax"):
            ops.bucket_unpack(torch.ones(1536), (1024, 512), 512)

    def test_pack_ragged_is_the_reference_concatenate(self):
        """The collective form: views at odd offsets and zero runs give
        ``jnp.concatenate`` of the same pieces."""
        base = _vectors([10007], seed=3)[0]
        t = torch.from_numpy(base)
        spans = [(3, 1030), 5, (1, 2), (100, 4197), 17, (9000, 10007)]
        pieces = [n if isinstance(n, int) else t[n[0]:n[1]] for n in spans]
        want = jnp.concatenate([jnp.zeros(n) if isinstance(n, int)
                                else jnp.asarray(base[n[0]:n[1]])
                                for n in spans])
        np.testing.assert_array_equal(ops.pack_ragged(pieces).numpy(),
                                      np.asarray(want))

    @pytest.mark.parametrize("rows", [1, 2, 3])
    def test_unpack_columns_is_the_reference_column_split(self, rows):
        """``gathered[:, off:off + w].reshape(-1)`` per block, as
        ``dist/collectives.py::gather_bucket`` slices the all-gather."""
        widths = (7, 1030, 1, 513)
        flat = _vectors([rows * sum(widths)], seed=rows)[0]
        grid = jnp.asarray(flat).reshape(rows, -1)
        off = 0
        for w, got in zip(widths, ops.unpack_columns(torch.from_numpy(flat),
                                                     widths, rows)):
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(grid[:, off:off + w].reshape(-1)))
            off += w

    def test_cpu_tensors_take_the_plain_version_without_launching(self):
        before = launch_counts()
        segs, alens = ops.pad_segments([torch.ones(700)])
        ops.bucket_unpack(ops.bucket_pack(segs, alens), alens, segs.shape[1])
        ops.unpack_columns(ops.pack_ragged([torch.ones(5), 3]), [8], 1)
        assert launch_counts() == before

    def test_other_devices_raise(self):
        with pytest.raises(ValueError, match="CPU or a CUDA device"):
            ops.pack_ragged([torch.ones(4, device="meta")])


FLASH_CASES = [
    # (b, h, hkv, t, hd, causal, window, cap)
    (1, 2, 1, 128, 64, True, 0, 0.0),          # GQA
    (1, 2, 2, 256, 64, True, 100, 30.0),       # window not block-aligned
    (1, 2, 1, 256, 64, True, 0, 50.0),         # GQA + softcap
    (1, 2, 2, 128, 80, False, 0, 0.0),         # encoder + odd head dim
]


def _qkv(b, h, hkv, t, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, t, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, t, hd)).astype(np.float32),
            rng.standard_normal((b, hkv, t, hd)).astype(np.float32))


class TestFlashAttention:
    @pytest.mark.parametrize("case", FLASH_CASES + [
        (2, 4, 4, 16, 64, True, 0, 0.0), (1, 3, 3, 77, 32, True, 20, 0.0)])
    def test_attention_ref_vs_jax_ref(self, case):
        b, h, hkv, t, hd, causal, window, cap = case
        q, k, v = _qkv(b, h, h, t, hd)
        got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window, softcap=cap)
        want = jax_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    @pytest.mark.parametrize("case", FLASH_CASES)
    def test_wrapper_vs_jax_pallas_interpret(self, case):
        b, h, hkv, t, hd, causal, window, cap = case
        q, k, v = _qkv(b, h, hkv, t, hd, seed=1)
        got = flash_ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                        causal, window, cap)
        want = jax_flash_ops.flash_attention(q, k, v, causal, window, cap,
                                             128, 128, True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    def test_bf16_vs_jax(self):
        q, k, v = _qkv(1, 4, 2, 128, 64, seed=2)
        got = flash_ops.flash_attention(
            *(_as_torch(x, torch.bfloat16) for x in (q, k, v)))
        want = jax_flash_ops._ref_fwd(
            *(_as_jax(x, jnp.bfloat16) for x in (q, k, v)), True, 0, 0.0)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)

    def test_gradients_match_jax_custom_vjp(self):
        """The reference's VJP is the oracle's; so is the port's backward."""
        import jax
        q, k, v = _qkv(1, 2, 1, 128, 64, seed=4)
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        (flash_ops.flash_attention(tq, tk, tv, True, 0, 0.0) ** 2).sum() \
            .backward()
        want = jax.grad(lambda *a: jnp.sum(jax_flash_ops.flash_attention(
            *a, True, 0, 0.0, 128, 128, True) ** 2), argnums=(0, 1, 2))(
                q, k, v)
        for got, w in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-5)

    def test_strided_model_layout_equals_contiguous(self):
        """The model hands (B, T, H, hd) tensors over through a transpose."""
        q, k, v = _qkv(2, 4, 2, 48, 64, seed=5)
        dense = [torch.from_numpy(x) for x in (q, k, v)]
        views = [x.transpose(1, 2).contiguous().transpose(1, 2)
                 for x in dense]
        assert not views[0].is_contiguous()
        assert torch.equal(flash_ops.flash_attention(*views),
                           flash_ops.flash_attention(*dense))

    def test_shape_errors_and_devices(self):
        q = torch.zeros(1, 3, 8, 16)
        with pytest.raises(ValueError, match="not a multiple"):
            flash_ops.flash_attention(q, torch.zeros(1, 2, 8, 16),
                                      torch.zeros(1, 2, 8, 16))
        with pytest.raises(ValueError, match="must be \\(B, H, T, hd\\)"):
            flash_ops.flash_attention(q[0], q[0], q[0])
        meta = torch.zeros(1, 2, 8, 16, device="meta")
        with pytest.raises(ValueError, match="CPU or a CUDA device"):
            flash_ops.flash_attention(meta, meta, meta)
        before = launch_counts()
        flash_ops.flash_attention(q, q, q)
        assert launch_counts() == before
