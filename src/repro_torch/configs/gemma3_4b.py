"""gemma3-4b [hf:google/gemma-3-1b-pt family] — 5:1 local:global, 128k ctx."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    citation="hf:google/gemma-3-1b-pt",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    head_dim=256,
    activation="geglu",
    gated_mlp=True,
    layer_pattern=("local_attn",) * 5 + ("global_attn",),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    supports_long_context=True,   # sliding window; global-layer KV data-sharded
)
