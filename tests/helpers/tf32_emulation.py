"""How far 3xTF32 products would move the flash forward from the plain
fp32 attention, emulated on the CPU: why ``csrc/flash_attention.cu`` keeps
Q K^T on fp32 FMAs.

    PYTHONPATH=src python tests/helpers/tf32_emulation.py

Causal attention at T = 1024 on the paths' heads (granite-3-2b: batch 2 x
32 heads of 64; recurrentgemma-2b: batch 2 x 10 heads of 256), q, k, v
standard normal from a numpy seed.  A 3xTF32 product splits each fp32
operand into a TF32 high part (10 mantissa bits) and the TF32 remainder,
each rounded to nearest as ``cvt.rna.tf32.f32`` rounds (ties away from
zero), and sums hi*hi + hi*lo + lo*hi with fp32 sums.  It replaces Q K^T,
P V or both; the largest absolute difference to the plain fp32 attention
is printed beside the f32 tolerance of the kernel checks, 2e-6.  The
emulation sums in IEEE fp32, which the tensor cores' accumulation need not
match, so the card can land further off.
"""

import numpy as np
import torch

T = 1024
CASES = (("hd 64 (granite-3-2b)", 2 * 32, 64),
         ("hd 256 (recurrentgemma-2b)", 2 * 10, 256))
HEADS_AT_ONCE = 4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to 10 mantissa bits, to nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def attention(q, k, v, qk, pv) -> torch.Tensor:
    s = qk(q, k.transpose(-1, -2)) / q.shape[-1] ** 0.5
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return pv(p, v)


def main() -> None:
    rng = np.random.default_rng(0)
    plain = torch.matmul
    for name, heads, hd in CASES:
        worst = {"both": 0.0, "QK^T only": 0.0, "P V only": 0.0}
        for _ in range(0, heads, HEADS_AT_ONCE):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (HEADS_AT_ONCE, T, hd)).astype(np.float32)) for _ in range(3))
            want = attention(q, k, v, plain, plain)
            for key, qk, pv in (("both", matmul3, matmul3),
                                ("QK^T only", matmul3, plain),
                                ("P V only", plain, matmul3)):
                err = (attention(q, k, v, qk, pv) - want).abs().max().item()
                worst[key] = max(worst[key], err)
        print(f"{name}, {heads} heads, T={T}: " + "; ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + " (f32 atol 2e-6)")


if __name__ == "__main__":
    main()
