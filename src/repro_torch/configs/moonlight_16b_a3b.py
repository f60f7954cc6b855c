"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B] (``deepseek_v3``).

27 layers at d_model 2048.  Every layer's mixer is multi-head latent
attention (MLA): 16 heads whose queries and keys are 128 dims without
positions and 64 with rope (theta 50,000), keys and values (128 a head)
decompressed from a 512-dim latent, the rope key one head shared by all
16.  Layer 0's MLP is a dense SwiGLU of 11,264; layers 1-26 route each
token to 6 of 64 experts of 1,408 by sigmoid scores shifted by a
correction bias (``noaux_tc``, one group), weigh them by the unshifted
scores normalised and scaled by 2.446, and add 2 shared experts (one
SwiGLU of 2,816).  No embedding multiplier, an untied head.  The published
model routes without a capacity; the port keeps its capacity factor of
1.25.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonlight-16b-a3b",
    family="moe",
    citation="hf:moonshotai/Moonlight-16B-A3B",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,             # q / k: qk_nope_head_dim + qk_rope_head_dim
    d_ff=1408,                # per-expert FFN width
    vocab_size=163840,
    num_experts=64,
    top_k=6,
    shared_d_ff=2816,         # 2 shared experts of 1408
    router_scoring="sigmoid",
    routed_scaling=2.446,
    seq_aux=True,
    first_dense_layers=1,
    dense_d_ff=11264,
    activation="silu",
    gated_mlp=True,
    layer_pattern=("mla",),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    embedding_multiplier=1.0,
    rope_theta=50000.0,
    norm_eps=1e-5,
    tie_embeddings=False,
)
