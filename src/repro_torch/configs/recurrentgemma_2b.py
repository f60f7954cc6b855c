"""recurrentgemma-2b [arXiv:2402.19427] — RG-LRU + local attention, 1:2."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    citation="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    activation="geglu",
    gated_mlp=True,
    layer_pattern=("rglru", "rglru", "local_attn"),
    sliding_window=2048,
    rglru_lru_width=2560,
    supports_long_context=True,   # O(1)-state recurrence + windowed attention
)
