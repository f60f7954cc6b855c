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
LayerKind = Literal["global_attn", "local_attn", "mlstm", "slstm", "rglru",
                    "mamba2", "mla"]
MlpKind = Literal["dense", "moe", "none"]


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
    position_embedding: Literal["rope", "nope"] = "rope"

    # muP multipliers (granite 4.0); the defaults are the port's plain model
    embedding_multiplier: Optional[float] = None   # None: sqrt(d_model)
    attention_multiplier: Optional[float] = None   # None: 1 / sqrt(head_dim)
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0              # logits are divided by it

    # MoE
    num_experts: int = 0                     # the router's width
    top_k: int = 0
    capacity_factor: float = 1.25
    # the expert share this device holds: experts first .. first + held - 1
    # (held 0: every expert); the router still routes over all of them
    experts_first: int = 0
    experts_held: int = 0
    shared_d_ff: int = 0                     # a shared SwiGLU expert's width
    # the router's scores: ``softmax``, or ``sigmoid`` (DeepSeek-V3's
    # noaux_tc): the experts are the top k of sigmoid + a correction bias,
    # weighted by their unshifted scores, normalised, times routed_scaling
    router_scoring: Literal["softmax", "sigmoid"] = "softmax"
    routed_scaling: float = 1.0
    seq_aux: bool = False                    # the aux loss per sequence
    # leading dense layers of an MoE model (first_k_dense_replace) and their
    # MLP's width
    first_dense_layers: int = 0
    dense_d_ff: int = 0

    # latent attention (``mla`` layers): q / k heads of qk_nope + qk_rope
    # (``head_dim``), v heads of v_head_dim; k's nope part and v are
    # decompressed from a kv_lora_rank latent, the rope key is one head
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid
    rglru_lru_width: Optional[int] = None    # default d_model
    mlstm_proj_factor: float = 2.0
    # Mamba-2 (``mamba2`` layers): heads of mamba_head_dim, d_state, groups
    mamba_heads: int = 0
    mamba_head_dim: int = 64
    mamba_d_state: int = 128
    mamba_groups: int = 1
    mamba_conv: int = 4
    mamba_chunk: int = 256                   # the SSD's chunk (train, prefill)

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
        last = self.experts_first + self.num_held_experts - 1
        if last >= self.num_experts:
            raise ValueError(f"{self.name}: experts {self.experts_first}.."
                             f"{last} lie outside the router's "
                             f"{self.num_experts}")

    # ------------------------------------------------------------------
    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def mlp_kinds(self) -> Tuple[MlpKind, ...]:
        """Each layer's MLP: ``moe``, ``dense`` (every layer of a model
        without experts, the leading ``first_dense_layers`` of one with
        them) or ``none`` (``d_ff`` 0: xLSTM blocks carry their own)."""
        def kind(i: int) -> MlpKind:
            if self.d_ff <= 0:
                return "none"
            return "moe" if self.is_moe and i >= self.first_dense_layers \
                else "dense"
        return tuple(kind(i) for i in range(self.num_layers))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def num_held_experts(self) -> int:
        """How many experts this device holds (all, unless a share)."""
        return self.experts_held or self.num_experts

    @property
    def mamba_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def mamba_conv_dim(self) -> int:
        """x, B and C: the channels of the Mamba-2 causal conv."""
        return self.mamba_inner + 2 * self.mamba_groups * self.mamba_d_state

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
        # Mamba-2: 4 heads spanning 2 x d_model, a state of 16, chunk 16
        mamba = dict(mamba_heads=4, mamba_head_dim=d_model // 2,
                     mamba_d_state=16, mamba_chunk=16) \
            if self.mamba_heads else {}
        # MLA: a latent of d_model / 4, q / k heads of 16 + 8, v heads of 16
        mla = dict(kv_lora_rank=d_model // 4, qk_nope_head_dim=16,
                   qk_rope_head_dim=8, v_head_dim=16, head_dim=24) \
            if self.kv_lora_rank else dict(head_dim=d_model // heads)
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            d_ff=max(d_model * 2, 64) if self.d_ff else 0,
            dense_d_ff=d_model * 4 if self.dense_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            vocab_size=vocab,
            num_experts=experts,
            top_k=top_k,
            experts_first=0,
            experts_held=0,
            shared_d_ff=d_model if self.shared_d_ff else 0,
            **mamba,
            **mla,
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
