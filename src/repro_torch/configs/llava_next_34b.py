"""llava-next-34b [hf:llava-hf/llava-v1.6-mistral-7b-hf] — anyres tiling.

Language backbone only; the SigLIP/ViT tower + projector is a stub that
supplies precomputed patch embeddings (``num_vision_tokens`` anyres tokens
prepended to the text sequence).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    frontend="vision",
    num_vision_tokens=2880,   # anyres: 5 tiles x 576 patches
)
