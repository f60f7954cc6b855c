from repro_torch.kernels.adamw.ops import adamw_update, fusable

__all__ = ["adamw_update", "fusable"]
