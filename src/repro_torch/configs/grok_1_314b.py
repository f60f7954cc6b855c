"""grok-1-314b [hf:xai-org/grok-1] — MoE 8 experts top-2; multi-pod stress case."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    citation="hf:xai-org/grok-1",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,               # per-expert FFN width
    vocab_size=131072,
    head_dim=128,
    num_experts=8,
    top_k=2,
    activation="gelu",
    gated_mlp=True,
    attn_logit_softcap=30.0,
    final_logit_softcap=30.0,
)
