"""The Mamba-2 SSD scan (``repro_torch.models.ssm.ssd_chunked``, inside the
port's ``mamba.scan`` span): one call's operations and bytes.

Operations are the chunked algorithm's multiply-adds at the configuration's
chunk Q, whatever implements it, over the chunks that cover T: per chunk
``C B^T`` (Q^2 N a group), ``(L o C B^T)(dt x)`` (Q^2 P a head), the
chunk's own state ``B^T (decay dt x)`` and the output from the state it
starts from (Q P N a head each); two operations a multiply-add.  Bytes
are x, dt, B and C read once and y written once.
"""

from __future__ import annotations

from typing import Any, Dict


def call(cfg: Dict[str, Any], b: int, t: int) -> Dict[str, int]:
    """One scan call of a configuration file's Mamba-2 layer at (b, t)."""
    return {"b": b, "t": t, "h": cfg["mamba_n_heads"],
            "p": cfg["mamba_d_head"], "n": cfg["mamba_d_state"],
            "g": cfg["mamba_n_groups"], "chunk": cfg["mamba_chunk_size"]}


def ops(b: int, t: int, h: int, p: int, n: int, g: int, chunk: int) -> int:
    chunks = -(-t // chunk)
    macs = chunk * chunk * (g * n + h * p) + 2 * chunk * h * p * n
    return 2 * b * chunks * macs


def nbytes(b: int, t: int, h: int, p: int, n: int, g: int,
           itemsize: int = 4) -> int:
    return itemsize * b * t * (2 * h * p + h + 2 * g * n)


def bound_s(c: Dict[str, int], peaks: dict) -> float:
    """The least time one call can take on the card."""
    o = ops(c["b"], c["t"], c["h"], c["p"], c["n"], c["g"], c["chunk"])
    m = nbytes(c["b"], c["t"], c["h"], c["p"], c["n"], c["g"])
    return max(o / peaks["flops"], m / peaks["bytes_per_s"])
