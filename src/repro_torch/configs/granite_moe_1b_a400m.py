"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,                 # per-expert FFN width
    vocab_size=49155,
    num_experts=32,
    top_k=8,
    activation="silu",
    gated_mlp=True,
    layer_pattern=("global_attn",),
)
