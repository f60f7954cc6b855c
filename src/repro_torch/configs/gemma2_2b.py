"""gemma2-2b [arXiv:2408.00118] — local/global alternating, logit softcap."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    citation="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    activation="geglu",
    gated_mlp=True,
    layer_pattern=("local_attn", "global_attn"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    supports_long_context=True,   # sliding window; global-layer KV data-sharded
)
