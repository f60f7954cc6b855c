"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small] (32B-A9B).

A hybrid of Mamba-2 and attention: of every ten layers, five Mamba-2,
one GQA attention layer without positions (NoPE), four Mamba-2.  Every
layer's MLP is a dropping top-10 MoE over 72 experts of width 768 with a
shared SwiGLU expert of width 1536, and the muP multipliers scale the
embedding (12), the attention scores (1/128), each residual branch (0.22)
and the tied logits (1/16).  The published model routes without a
capacity; the port keeps its capacity factor of 1.25.
"""

from repro_torch.configs.base import ArchConfig

PATTERN = ("mamba2",) * 5 + ("global_attn",) + ("mamba2",) * 4

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    citation="hf:ibm-granite/granite-4.0-h-small",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,                 # per-expert FFN width
    vocab_size=100352,
    num_experts=72,
    top_k=10,
    shared_d_ff=1536,
    activation="silu",
    gated_mlp=True,
    layer_pattern=PATTERN,
    position_embedding="nope",
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    mamba_heads=128,
    mamba_head_dim=64,
    mamba_d_state=128,
    mamba_groups=1,
    mamba_conv=4,
    mamba_chunk=256,
    norm_eps=1e-5,
    tie_embeddings=True,
)
