"""The port's compression kernels and compressor against the JAX package's
(on the CPU).

Inputs are made with numpy from a seed and handed to both packages.  Every
comparison is exact: the plain versions against the reference's refs run
under ``jax.jit`` (the arithmetic the reference trains with: XLA rewrites
``absmax / 127`` into ``absmax * fp32(1/127)`` there) by bits, and against
the interpret-mode Pallas kernels with ``assert_array_equal`` (which takes
+0.0 == -0.0: the one-hot Pallas ``sparsify`` drops the sign of a chosen
-0.0 that ``sparsify_ref`` keeps).  On the CPU every wrapper takes its
plain version; ``test_torch_gpu.py`` and ``chip_smoke.py`` hold the CUDA
kernels against the same plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import make_compressor as jax_make_compressor
from repro.kernels.compress import ops as jax_ops
from repro.kernels.compress import ref as jax_ref
from repro_torch.compress import (SCHEMES, Compressor, Int8Compressor,
                                  TopKCompressor, make_compressor)
from repro_torch.kernels import launch_counts
from repro_torch.kernels.compress import ops, ref

LENGTHS = [(512,), (512, 1024), (2048, 512, 512, 1024), (512,) * 7]
TOPK_CASES = [((512,), 5), ((512, 1024), 32), ((256, 700, 513), 17),
              ((4096, 3000, 100), 200), ((64, 7), 20)]


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({4: np.int32, 1: np.int8}[a.dtype.itemsize])


def assert_bitwise(got, want):
    a, b = _bits(got), _bits(want)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _segments(lengths, seed=0):
    """(K, Lmax) rows, zero past each length: scaled normals, an all-zero
    tile, a tiny tile and -0.0 entries."""
    rng = np.random.default_rng(seed)
    lmax = max(lengths)
    segs = np.zeros((len(lengths), lmax), np.float32)
    for i, n in enumerate(lengths):
        segs[i, :n] = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3)
    segs[0, :min(lengths[0], 512)] *= 1e-3
    if len(lengths) > 1:
        segs[1, :512] = 0.0
        segs[1, 600:610] = -0.0
    return segs


_jit_quantize = jax.jit(jax_ref.quantize_pack_ref, static_argnums=1)
_jit_dequantize = jax.jit(jax_ref.dequantize_unpack_ref,
                          static_argnums=(2, 3))
_jit_sparsify = jax.jit(jax_ref.sparsify_ref)
_jit_densify = jax.jit(jax_ref.densify_ref, static_argnums=2)


class TestInt8:
    @pytest.mark.parametrize("lengths", LENGTHS)
    def test_plain_bitwise_vs_jitted_reference(self, lengths):
        segs = _segments(lengths)
        payload, scales = ops.quantize_pack(torch.from_numpy(segs), lengths)
        jp, js = _jit_quantize(jnp.asarray(segs), lengths)
        assert payload.dtype == torch.int8
        assert_bitwise(payload, jp)
        assert_bitwise(scales, js)
        lmax = segs.shape[1]
        assert_bitwise(ops.dequantize_unpack(payload, scales, lengths, lmax),
                       _jit_dequantize(jp, js, lengths, lmax))

    @pytest.mark.parametrize("lengths", LENGTHS)
    def test_plain_equals_interpret_pallas(self, lengths):
        """Also for (512,)*7, where the interpret-mode kernel equals the
        jitted ref and not the eager one (see ROADMAP queue 3)."""
        segs = _segments(lengths)
        payload, scales = ops.quantize_pack(torch.from_numpy(segs), lengths)
        jp, js = jax_ops.quantize_pack(jnp.asarray(segs), lengths,
                                       interpret=True)
        np.testing.assert_array_equal(payload.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
        lmax = segs.shape[1]
        np.testing.assert_array_equal(
            ops.dequantize_unpack(payload, scales, lengths, lmax).numpy(),
            np.asarray(jax_ops.dequantize_unpack(jp, js, lengths, lmax,
                                                 interpret=True)))

    def test_inv_and_scale_equal_jit_on_200k_values(self):
        """The two divisions of the int8 step: ``127 / absmax`` is a true
        division under jit, ``absmax / 127`` a product with fp32(1/127)."""
        rng = np.random.default_rng(1)
        a = np.abs(rng.standard_normal(200_000).astype(np.float32)
                   * np.float32(10.0) ** rng.integers(-6, 6, 200_000)
                   .astype(np.float32))
        t = torch.from_numpy(a)
        inv = torch.full_like(t, 127.0) / t
        scale = t * torch.tensor(1 / 127, dtype=torch.float32)
        assert_bitwise(inv, jax.jit(lambda x: 127.0 / x)(a))
        assert_bitwise(scale, jax.jit(lambda x: x / 127.0)(a))
        # the trap: a reciprocal times 127 is not the quotient
        assert not np.array_equal(_bits(127.0 / t), _bits(inv))

    def test_nan_and_saturation_like_xla(self):
        """NaN converts to 0 and out-of-range values saturate, as XLA's
        float→int8 conversion does; a NaN tile decodes to NaN."""
        segs = _segments((1024,), seed=2)
        segs[0, 7] = np.nan
        payload, scales = ops.quantize_pack(torch.from_numpy(segs), (1024,))
        jp, js = _jit_quantize(jnp.asarray(segs), (1024,))
        np.testing.assert_array_equal(payload.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
        out = ops.dequantize_unpack(payload, scales, (1024,), 1024)
        assert np.isnan(out[0, :512].numpy()).all()
        assert np.isfinite(out[0, 512:].numpy()).all()

    def test_cpu_calls_launch_nothing(self):
        before = launch_counts()
        segs = torch.from_numpy(_segments((512,)))
        ops.dequantize_unpack(*ops.quantize_pack(segs, (512,)), (512,), 512)
        idx = ops.topk_indices(segs, (512,), 4)
        ops.densify(ops.sparsify(segs, idx), idx, 512)
        assert launch_counts() == before


class TestTopK:
    @pytest.mark.parametrize("lengths,k", TOPK_CASES)
    def test_indices_equal_reference(self, lengths, k):
        segs = _segments(lengths, seed=3)
        np.testing.assert_array_equal(
            ops.topk_indices(torch.from_numpy(segs), lengths, k).numpy(),
            np.asarray(jax_ops.topk_indices(jnp.asarray(segs), lengths, k)))

    def test_ties_signed_zeros_and_short_rows(self):
        """Ties break to the lower index, ±0 tie with each other, and rows
        with fewer valid positions than k pad with -1 at the front."""
        rng = np.random.default_rng(4)
        segs = np.round(rng.standard_normal((3, 4096)) * 2).astype(np.float32)
        segs[0, 10:20] = 0.0
        segs[0, 20:30] = -0.0
        segs[2, :] = 0.0
        segs[2, 5] = -0.0
        lengths = (4096, 3000, 100)
        for k in (1, 50, 200, 4096):
            got = ops.topk_indices(torch.from_numpy(segs), lengths, k)
            want = jax_ops.topk_indices(jnp.asarray(segs), lengths, k)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        short = ops.topk_indices(torch.tensor([[1.0, 2.0, 0.0, 0.0]]),
                                 (2,), 3)
        assert short[0].tolist() == [-1, 0, 1]

    @pytest.mark.parametrize("lengths,k", TOPK_CASES)
    def test_sparsify_densify_bitwise_vs_jitted_reference(self, lengths, k):
        segs = _segments(lengths, seed=5)
        idx = ops.topk_indices(torch.from_numpy(segs), lengths, k)
        jidx = jnp.asarray(idx.numpy())
        vals = ops.sparsify(torch.from_numpy(segs), idx)
        jvals = _jit_sparsify(jnp.asarray(segs), jidx)
        assert_bitwise(vals, jvals)
        lmax = segs.shape[1]
        assert_bitwise(ops.densify(vals, idx, lmax),
                       _jit_densify(jvals, jidx, lmax))

    @pytest.mark.parametrize("lengths,k", TOPK_CASES)
    def test_sparsify_densify_equal_interpret_pallas(self, lengths, k):
        segs = _segments(lengths, seed=6)
        idx = ops.topk_indices(torch.from_numpy(segs), lengths, k)
        jidx = jnp.asarray(idx.numpy())
        vals = ops.sparsify(torch.from_numpy(segs), idx)
        jvals = jax_ops.sparsify(jnp.asarray(segs), jidx, interpret=True)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        lmax = segs.shape[1]
        np.testing.assert_array_equal(
            ops.densify(vals, idx, lmax).numpy(),
            np.asarray(jax_ops.densify(jvals, jidx, lmax, interpret=True)))

    def test_chosen_negative_zero_densifies_to_positive_zero(self):
        """``.at[].add`` into zeros turns a chosen -0.0 into +0.0; the
        port's ``0.0 + v`` does the same, and sparsify keeps the sign."""
        segs = np.zeros((1, 8), np.float32)
        segs[0, 3] = -0.0
        idx = torch.tensor([[-1, 3]], dtype=torch.int32)
        vals = ops.sparsify(torch.from_numpy(segs), idx)
        assert _bits(vals)[0, 1] == _bits(np.float32(-0.0))
        dense = ops.densify(vals, idx, 8)
        assert_bitwise(dense, _jit_densify(jnp.asarray(vals.numpy()),
                                           jnp.asarray(idx.numpy()), 8))
        assert (_bits(dense) == 0).all()


_ERRORS = [
    ("quantize", lambda: ops.quantize_pack(torch.ones(2, 512,
                                                      dtype=torch.bfloat16),
                                           (512, 512)), "float32"),
    ("quantize", lambda: ops.quantize_pack(torch.ones(2, 100), (512, 512)),
     "multiple of"),
    ("quantize", lambda: ops.quantize_pack(torch.ones(2, 512), (512,)),
     "aligned lengths"),
    ("quantize", lambda: ops.quantize_pack(torch.ones(512), (512,)),
     "must be \\(K, Lmax\\)"),
    ("dequantize", lambda: ops.dequantize_unpack(
        torch.zeros(1023, dtype=torch.int8), torch.zeros(2), (512, 512), 512),
     "payload"),
    ("dequantize", lambda: ops.dequantize_unpack(
        torch.zeros(1024, dtype=torch.int8), torch.zeros(1), (512, 512), 512),
     "scales"),
    ("topk", lambda: ops.topk_indices(torch.ones(2, 16), (16, 16), 0),
     "out of range"),
    ("topk", lambda: ops.topk_indices(torch.ones(2, 16), (16,), 4),
     "lengths"),
    ("sparsify", lambda: ops.sparsify(torch.ones(2, 16),
                                      torch.zeros(3, 4, dtype=torch.int32)),
     "indices must be"),
    ("sparsify", lambda: ops.sparsify(torch.ones(2, 16), torch.zeros(2, 4)),
     "integer"),
    ("densify", lambda: ops.densify(torch.ones(3, 4),
                                    torch.zeros(2, 4, dtype=torch.int32), 16),
     "indices must be"),
]


@pytest.mark.parametrize("which,call,match", _ERRORS,
                         ids=[f"{e[0]}-{i}" for i, e in enumerate(_ERRORS)])
def test_the_reference_value_errors(which, call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_rows_past_their_length_raise():
    """The reference reads past the row (quantize) or drops its tail
    (dequantize); the port refuses."""
    with pytest.raises(ValueError, match="exceed the row length"):
        ops.quantize_pack(torch.ones(1, 512), (1024,))
    payload, scales = ops.quantize_pack(torch.ones(1, 1024), (1024,))
    with pytest.raises(ValueError, match="exceed lmax"):
        ops.dequantize_unpack(payload, scales, (1024,), 512)


class TestCompressor:
    @pytest.mark.parametrize("scheme,frac", [("none", None), ("int8", None),
                                             ("topk", 0.01), ("topk", 0.3)])
    def test_wire_bytes_and_ratio_equal_reference(self, scheme, frac):
        mine = make_compressor(scheme, topk_fraction=frac)
        theirs = jax_make_compressor(scheme, topk_fraction=frac)
        logical = np.asarray([4.0, 4.0 * 511, 4.0 * 512, 4.0 * 513, 4e6,
                              4.0 * 100_669_440])
        np.testing.assert_array_equal(mine.wire_bytes(logical),
                                      theirs.wire_bytes(logical))
        for b in logical:
            assert mine.wire_bytes(float(b)) == theirs.wire_bytes(float(b))
            assert mine.ratio(float(b)) == theirs.ratio(float(b))
        assert mine.segment_overhead_bytes == theirs.segment_overhead_bytes
        assert mine.scheme == theirs.scheme

    def test_int8_prices_a_one_element_buffer_at_five_bytes(self):
        """Verbatim formula, inherited quirk (ROADMAP queue 3)."""
        assert Int8Compressor().wire_bytes(4.0) == 5.0

    @pytest.mark.parametrize("scheme,frac,n", [
        ("int8", None, 700), ("int8", None, 4096), ("int8", None, 1),
        ("topk", 0.01, 700), ("topk", 0.1, 4096), ("topk", 1.0, 33)])
    @pytest.mark.parametrize("residual_scale", [0.0, 1e-3])
    def test_feedback_roundtrip_bitwise_vs_jitted_reference(
            self, scheme, frac, n, residual_scale):
        """In place: the sum goes into ``flat`` and the new residual into
        ``residual``; a zero residual is every push's first step."""
        rng = np.random.default_rng(n)
        flat = rng.standard_normal(n).astype(np.float32)
        residual = (rng.standard_normal(n)
                    * residual_scale).astype(np.float32)
        theirs = jax_make_compressor(scheme, topk_fraction=frac,
                                     use_kernel=False)
        want_c, want_r = jax.jit(theirs.feedback_roundtrip)(
            jnp.asarray(flat), jnp.asarray(residual))
        mine = make_compressor(scheme, topk_fraction=frac)
        res = torch.from_numpy(residual.copy())
        got_c, got_r = mine.feedback_roundtrip(
            torch.from_numpy(flat.copy()), res)
        assert_bitwise(got_c, want_c)
        assert_bitwise(got_r, want_r)
        assert got_r is res

    @pytest.mark.parametrize("scheme,frac", [("int8", None), ("topk", 0.1)])
    def test_error_feedback_algebra(self, scheme, frac):
        """The residual is what the wire dropped: top-k exactly
        (``compressed + residual == flat + residual``); int8 to one
        rounding, since its residual is ``corrected - q * scale`` rounded
        once (XLA's fused multiply-add) and the sum rounds again."""
        comp = make_compressor(scheme, topk_fraction=frac)
        rng = np.random.default_rng(7)
        flat = torch.from_numpy(rng.standard_normal(700).astype(np.float32))
        residual = torch.from_numpy(
            (rng.standard_normal(700) * 1e-3).astype(np.float32))
        corrected = flat + residual
        compressed, new_res = comp.feedback_roundtrip(flat.clone(),
                                                      residual.clone())
        if scheme == "topk":
            assert torch.equal(compressed + new_res, corrected)
        else:
            ulp = torch.finfo(torch.float32).eps * corrected.abs()
            assert ((compressed + new_res - corrected).abs() <= ulp).all()
            q, s = ops.quantize_pack(
                torch.nn.functional.pad(corrected, (0, 324))[None], (1024,))
            exact = (corrected.double() - q[:700].double()
                     * s.repeat_interleave(512)[:700].double())
            assert torch.equal(new_res, exact.float())

    def test_identity_and_validation(self):
        flat = torch.arange(8.0)
        assert Compressor().roundtrip(flat) is flat
        assert Compressor().ratio(1234.0) == 1.0
        assert SCHEMES == ("none", "int8", "topk")
        assert isinstance(make_compressor("topk", topk_fraction=0.1),
                          TopKCompressor)
        for kwargs, match in (
                (dict(scheme="gzip"), "unknown compression scheme"),
                (dict(scheme="int8", topk_fraction=0.1), "topk_fraction"),
                (dict(scheme="none", topk_fraction=0.1), "topk_fraction"),
                (dict(scheme="topk"), "requires topk_fraction"),
                (dict(scheme="topk", topk_fraction=1.5), "in \\(0, 1\\]")):
            with pytest.raises(ValueError, match=match):
                make_compressor(**kwargs)

    @pytest.mark.parametrize("n", [1, 511, 512, 513, 10_000])
    def test_topk_k_for_equals_reference(self, n):
        for frac in (0.01, 0.1, 1.0):
            assert TopKCompressor(fraction=frac).k_for(n) == \
                jax_make_compressor("topk", topk_fraction=frac).k_for(n)
