"""hubert-xlarge [arXiv:2106.07447] — encoder-only, wav2vec2-style backbone.

The conv/mel frontend is a stub supplying precomputed frame embeddings.
No decode step exists for this architecture (see DESIGN.md skip notes).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    citation="arXiv:2106.07447",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    gated_mlp=False,
    causal=False,
    encoder_only=True,
    frontend="audio",
    tie_embeddings=False,
)
