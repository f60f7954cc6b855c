"""Gradient compression for the transmission hot path.

The push direction (worker → server gradients) dominates the wire on
asymmetric edge uplinks, so this package compresses pushes only; pulls
stay fp32.  ``make_compressor`` builds a scheme, the ZeRO / PS trainers
carry it (with error-feedback residuals in trainer state), and the cost
model takes it as a first-class input so the DP re-segments under the
cheaper ``gt``.
"""

from repro_torch.compress.compressor import (SCHEMES, Compressor,
                                             Int8Compressor, TopKCompressor,
                                             make_compressor)

__all__ = ["SCHEMES", "Compressor", "Int8Compressor", "TopKCompressor",
           "make_compressor"]
