"""The port's Mamba-2 mixer (``models/ssm.py``) on the CPU.

The chunked SSD scan against the recurrence written out step by step and
against the benchmark's plain reference (``portbench/reference/
granite_hybrid.py``: the quadratic dual form over the whole sequence, an
independent algorithm); the mixer's output and gradients against the
reference's; prefill then decode through the state against the full
forward.  Decays in the published range (A in [-16, -1], dt in [1e-3,
1e-1]), T not a multiple of the chunk (chunk 8, T 37).

Tolerances.  Every computation here is float32; the loop is float64.  The
scan's outputs sum at most T = 37 terms of a few products each, so they
agree to ~1e-6 of their largest magnitude; each check below allows 1e-5
of the compared tensor's largest magnitude (``_gap``), ten times that, and
a missing term (a chunk's carried state, a skipped step) moves them by
far more (``test_the_carried_state_matters``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import granite_hybrid as ref
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.models import ssm
from repro_torch.serve import decode

TOL = 1e-5          # of the compared tensor's largest magnitude (above)


def _gap(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max())


def _inputs(seed=0, b=2, t=37, h=4, p=8, g=2, n=6):
    """x, dt, A, B, C with published-range decays."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=gen)
    dt = torch.exp(torch.empty(b, t, h).uniform_(
        np.log(1e-3), np.log(1e-1), generator=gen))
    A = -torch.empty(h).uniform_(1.0, 16.0, generator=gen)
    B = torch.randn(b, t, g, n, generator=gen)
    C = torch.randn(b, t, g, n, generator=gen)
    return x, dt, A, B, C


def _loop(x, dt, A, B, C, state=None):
    """The recurrence step by step in float64."""
    b, t, h, p = x.shape
    r = h // B.shape[2]
    s = torch.zeros(b, h, p, B.shape[3], dtype=torch.float64) \
        if state is None else state.double()
    ys = []
    for i in range(t):
        Bh = B[:, i].double().repeat_interleave(r, dim=1)
        Ch = C[:, i].double().repeat_interleave(r, dim=1)
        a = torch.exp(dt[:, i].double() * A.double())
        s = a[..., None, None] * s \
            + (dt[:, i, :, None].double() * x[:, i].double())[..., None] \
            * Bh[:, :, None]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Ch))
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("t,chunk", [(37, 8), (8, 8), (5, 8), (64, 16)])
def test_chunked_scan_is_the_recurrence(t, chunk):
    x, dt, A, B, C = _inputs(t=t)
    y, s = ssm.ssd_chunked(x, dt, A, B, C, chunk)
    want_y, want_s = _loop(x, dt, A, B, C)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _gap(y, want_y) < TOL
    assert _gap(s, want_s) < TOL


def test_chunked_scan_carries_an_initial_state():
    x, dt, A, B, C = _inputs()
    s0 = torch.randn(2, 4, 8, 6, generator=torch.Generator().manual_seed(5))
    y, s = ssm.ssd_chunked(x, dt, A, B, C, 8, initial=s0)
    want_y, want_s = _loop(x, dt, A, B, C, s0)
    assert _gap(y, want_y) < TOL and _gap(s, want_s) < TOL


def test_the_carried_state_matters():
    """Heads that keep their state across a chunk (A near -1, dt 0.1 over
    8 steps keeps exp(-0.8)): dropping the state passed between chunks
    moves the output far beyond the tolerance."""
    x, dt, A, B, C = _inputs()
    A = torch.full_like(A, -1.0)
    dt = torch.full_like(dt, 0.1)
    y, _ = ssm.ssd_chunked(x, dt, A, B, C, 8)
    alone = torch.cat([ssm.ssd_chunked(x[:, lo:lo + 8], dt[:, lo:lo + 8], A,
                                       B[:, lo:lo + 8], C[:, lo:lo + 8],
                                       8)[0] for lo in range(0, 37, 8)],
                      dim=1)
    assert _gap(y, _loop(x, dt, A, B, C)[0]) < TOL
    assert _gap(alone, y) > 100 * TOL


@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_chunked_scan_is_the_references_quadratic_form(chunk):
    """Outputs and the gradients of x, dt, A, B and C."""
    leaves = [v.requires_grad_() for v in _inputs(seed=1)]
    y = ssm.ssd_chunked(*leaves, chunk)[0]
    want = ref.ssd(*leaves)
    assert _gap(y, want) < TOL
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(y, leaves, g)
    theirs = torch.autograd.grad(want, leaves, g)
    for a, b in zip(got, theirs):
        assert _gap(a, b) < TOL


def _mixer_cfg(**changes):
    cfg = get_config("granite-4.0-h-small").reduced(d_model=32)
    return dataclasses.replace(cfg, mamba_chunk=8, mamba_groups=2,
                               **changes)


def _ref_cfg(cfg):
    return {"mamba_n_heads": cfg.mamba_heads,
            "mamba_d_head": cfg.mamba_head_dim,
            "mamba_n_groups": cfg.mamba_groups,
            "mamba_d_state": cfg.mamba_d_state,
            "mamba_d_conv": cfg.mamba_conv, "rms_norm_eps": cfg.norm_eps}


REF_ORDER = ("in_proj", "conv", "conv_bias", "dt_bias", "A_log", "D",
             "norm", "out_proj")


def _mixer_params(cfg, seed=0):
    p = ssm.init_mamba2_params(torch.Generator().manual_seed(seed), cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    # draws in the published range, and a norm and conv bias off zero
    p["norm"] = 0.1 * torch.randn(p["norm"].shape, generator=gen)
    p["conv_bias"] = 0.1 * torch.randn(p["conv_bias"].shape, generator=gen)
    p["D"] = torch.randn(p["D"].shape, generator=gen)
    return {k: v.requires_grad_() for k, v in p.items()}


def test_the_mixer_is_the_references():
    """Output and every parameter's and the input's gradient."""
    cfg = _mixer_cfg()
    p = _mixer_params(cfg)
    x = torch.randn(2, 37, cfg.d_model,
                    generator=torch.Generator().manual_seed(3),
                    requires_grad=True)
    out, state = ssm.apply_mamba2(p, x, cfg, mode="train")
    want = ref.mamba(_ref_cfg(cfg), x, *(p[k] for k in REF_ORDER))
    assert state is None
    assert _gap(out, want) < TOL
    leaves = [x] + [p[k] for k in REF_ORDER]
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    for a, b in zip(torch.autograd.grad(out, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        assert _gap(a, b) < TOL


def test_prefill_state_then_decode_steps_continue_the_scan():
    """The mixer over 37 tokens against 29 in prefill and 8 decode steps
    from its state; the state after the last step against the prefill's
    over all 37."""
    cfg = _mixer_cfg()
    p = {k: v.detach() for k, v in _mixer_params(cfg).items()}
    x = torch.randn(2, 37, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    full, whole = ssm.apply_mamba2(p, x, cfg, mode="prefill")
    out, state = ssm.apply_mamba2(p, x[:, :29], cfg, mode="prefill")
    outs = [out]
    for i in range(29, 37):
        o, state = ssm.apply_mamba2(p, x[:, i:i + 1], cfg, mode="decode",
                                    state=state)
        outs.append(o)
    assert _gap(torch.cat(outs, dim=1), full) < TOL
    assert _gap(state.conv, whole.conv) < TOL
    assert _gap(state.ssm, whole.ssm) < TOL
    empty = model_lib.blocks.init_block_cache(cfg, "mamba2", 2, 64)
    assert empty.conv.shape == (2, cfg.mamba_conv_dim, cfg.mamba_conv - 1)
    assert empty.ssm.shape == (2, cfg.mamba_heads, cfg.mamba_head_dim,
                               cfg.mamba_d_state)


def test_prefill_then_decode_gives_the_full_forwards_logits():
    """The hybrid (Mamba-2 and NoPE attention layers, the shared expert,
    the multipliers) served: prefill 29 tokens, then decode 8 through the
    caches, against the full forward's logits at those positions."""
    cfg = dataclasses.replace(
        get_config("granite-4.0-h-small").reduced(num_layers=7, d_model=32),
        num_experts=8, top_k=2, mamba_chunk=8, capacity_factor=8.0)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(1))
    full, _, _ = model_lib.forward(cfg, params, {"tokens": tokens})
    logits, caches = decode.prefill(cfg, params, {"tokens": tokens[:, :29]},
                                    max_len=37)
    got = [logits[:, -1]]
    for i in range(29, 36):
        logits, caches = model_lib.decode_step(cfg, params,
                                               tokens[:, i:i + 1], caches)
        got.append(logits[:, -1])
    assert cfg.layer_kinds().count("global_attn") == 1
    assert _gap(torch.stack(got, dim=1), full[:, 28:36]) < TOL
