"""Plain PyTorch versions of bucket pack / unpack (the kernels' oracles)."""

from __future__ import annotations

from typing import List, Sequence, Union

import torch


def bucket_pack_ref(segments: torch.Tensor, lengths: Sequence[int]
                    ) -> torch.Tensor:
    """segments: (K, Lmax); lengths[i] <= Lmax → flat (sum(lengths),)."""
    return torch.cat([segments[i, :l] for i, l in enumerate(lengths)])


def bucket_unpack_ref(flat: torch.Tensor, lengths: Sequence[int],
                      lmax: int) -> torch.Tensor:
    """flat (sum(lengths),) → (K, Lmax) zero-padded."""
    out, off = [], 0
    for l in lengths:
        seg = flat[off:off + l]
        out.append(torch.nn.functional.pad(seg, (0, lmax - l)))
        off += l
    return torch.stack(out)


def pack_ragged_ref(segments: Sequence[Union[torch.Tensor, int]], *,
                    dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Concatenate 1-D segments; an ``int`` n stands for n zeros."""
    parts = [torch.zeros(s, dtype=dtype, device=device) if isinstance(s, int)
             else s.reshape(-1) for s in segments]
    return torch.cat(parts)


def unpack_columns_ref(flat: torch.Tensor, widths: Sequence[int],
                       rows: int) -> List[torch.Tensor]:
    """flat ``(rows * sum(widths),)`` viewed ``(rows, sum(widths))`` → one
    ``(rows * widths[k],)`` buffer per column block k, rows in order."""
    grid = flat.reshape(rows, -1)
    out, off = [], 0
    for w in widths:
        out.append(grid[:, off:off + w].reshape(-1).clone())
        off += w
    return out
