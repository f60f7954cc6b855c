"""Architecture configuration system.

One ``ArchConfig`` per assigned architecture (plus the paper's own CNNs,
which live in ``repro_torch.models.cnn`` as layer-cost tables).  Configs are plain
frozen dataclasses — no framework magic — and every field needed by the
model builder, the sharding rules, the profiler and the dry-run lives here.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

Family = Literal["dense", "moe", "ssm", "vlm", "audio", "hybrid"]
LayerKind = Literal["global_attn", "local_attn", "mlstm", "slstm", "rglru"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    citation: str

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // num_heads
    activation: str = "silu"                # silu | geglu | gelu
    gated_mlp: bool = True                  # SwiGLU/GeGLU-style 3-matrix MLP

    # attention pattern
    layer_pattern: Tuple[LayerKind, ...] = ()   # cycled over num_layers
    sliding_window: int = 0                  # for local_attn layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    causal: bool = True                      # False for encoder-only (hubert)

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    rglru_lru_width: Optional[int] = None    # default d_model
    mlstm_proj_factor: float = 2.0

    # modality frontend (stubbed): inputs are precomputed embeddings
    frontend: Literal["none", "vision", "audio"] = "none"
    num_vision_tokens: int = 0               # anyres patches prepended (vlm)

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    # capability flags for shape selection
    encoder_only: bool = False
    supports_long_context: bool = False      # sub-quadratic decode path exists

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern", ("global_attn",))
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads not divisible by kv heads")

    # ------------------------------------------------------------------
    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims (CPU-runnable)."""
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        while heads % kv:
            kv -= 1
        experts = min(self.num_experts, 4) if self.is_moe else 0
        top_k = min(self.top_k, experts) if experts else 0
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=max(d_model * 2, 64) if self.d_ff else 0,
            vocab_size=vocab,
            num_experts=experts,
            top_k=top_k,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            rglru_lru_width=d_model if self.rglru_lru_width else None,
            num_vision_tokens=min(self.num_vision_tokens, 16),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) — the skip policy documented in DESIGN.md."""
    if shape.mode == "decode" and cfg.encoder_only:
        return False, "encoder-only architecture: no decode step exists"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention architecture without a "
                       "sub-quadratic variant; long-context decode skipped")
    return True, ""
