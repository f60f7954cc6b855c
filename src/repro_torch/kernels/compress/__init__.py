from repro_torch.kernels.compress.ops import (TILE, aligned, densify,
                                              dequantize_unpack, quantize_pack,
                                              sparsify, topk_indices)

__all__ = ["TILE", "aligned", "quantize_pack", "dequantize_unpack",
           "topk_indices", "sparsify", "densify"]
