"""gemma-7b [arXiv:2403.08295] — GeGLU, head_dim=256."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    citation="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    activation="geglu",
    gated_mlp=True,
)
