from repro_torch.serve.decode import (batched_generate, build_decode_step,
                                      pad_caches, prefill)

__all__ = ["pad_caches", "prefill", "build_decode_step", "batched_generate"]
