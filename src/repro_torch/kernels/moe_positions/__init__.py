from repro_torch.kernels.moe_positions.ops import MAX_EXPERTS, moe_positions

__all__ = ["MAX_EXPERTS", "moe_positions"]
