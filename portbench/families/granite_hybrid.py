"""The granite 4.0-H hybrids as the port runs them: Mamba-2 and NoPE GQA
attention layers as ``layer_types`` orders them, each with an MoE MLP
(this device's share of the experts) and a shared SwiGLU expert, the muP
multipliers and a tied head.

Leaves are named ``(kind, index)``.  A kind every layer has is indexed by
the layer (``("router", 3)``); a mixer's kinds by the layer's place among
the layers of its kind (``("wq", 0)``: the first attention layer;
``("in_proj", 8)``: the ninth Mamba-2 layer), as
``portbench/reference/granite_hybrid.py`` holds them.  Dense weights are
``(in, out)``; norm scales are drawn as zeros (the models scale by
``1 + scale``).

The configuration file holds the source's keys; ``num_hidden_layers`` and
``layer_types`` are the layers this device runs, ``num_local_experts`` the
experts it holds from ``first_local_expert`` on, and
``num_router_experts`` the router's width (the published expert count).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from portbench.counts import granite_hybrid_flops as flops  # noqa: F401

# configuration-file key -> the port's ArchConfig field
ARCH_FIELDS = {"hidden_size": "d_model",
               "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads",
               "head_dim": "head_dim", "intermediate_size": "d_ff",
               "shared_intermediate_size": "shared_d_ff",
               "vocab_size": "vocab_size", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "num_router_experts": "num_experts",
               "num_experts_per_tok": "top_k",
               "capacity_factor": "capacity_factor",
               "position_embedding_type": "position_embedding",
               "embedding_multiplier": "embedding_multiplier",
               "attention_multiplier": "attention_multiplier",
               "residual_multiplier": "residual_multiplier",
               "logits_scaling": "logits_scaling",
               "mamba_n_heads": "mamba_heads",
               "mamba_d_head": "mamba_head_dim",
               "mamba_d_state": "mamba_d_state",
               "mamba_n_groups": "mamba_groups",
               "mamba_d_conv": "mamba_conv",
               "mamba_chunk_size": "mamba_chunk"}
KINDS = {"mamba": "mamba2", "attention": "global_attn"}
# the published layer's fixed choices, which the port's Mamba-2 and
# attention make
FIXED = {"hidden_act": "silu", "mamba_conv_bias": True,
         "mamba_proj_bias": False, "attention_bias": False,
         "normalization_function": "rmsnorm"}

# the std of each drawn kind that is not a dense weight; A_log's is wide,
# so that some heads keep their state across a chunk and the state passes
# between chunks (PERF.md, section 4: the share of such heads)
STDS = {"conv_bias": 0.0, "dt_bias": 1.0, "A_log": 4.0, "D": 1.0,
        "m_norm": 0.0}


def arch_for(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` named by the file (``arch``) cut to the
    file's layers and expert share, with the file's ``program_overrides``
    (test-size files only); every size and choice the configuration as
    run states must be the one the port runs."""
    from repro_torch.configs import get_config
    arch = dataclasses.replace(
        get_config(cfg["arch"]), num_layers=cfg["num_hidden_layers"],
        experts_first=cfg["first_local_expert"],
        experts_held=cfg["num_local_experts"],
        **cfg.get("program_overrides", {}))
    for key, field in ARCH_FIELDS.items():
        if getattr(arch, field) != cfg[key]:
            raise ValueError(f"{cfg['name']}: the file states {key} = "
                             f"{cfg[key]!r}, the port's {arch.name} runs "
                             f"{field} = {getattr(arch, field)!r}")
    kinds = tuple(KINDS[k] for k in
                  cfg["layer_types"][:cfg["num_hidden_layers"]])
    wrong = [k for k, v in FIXED.items() if cfg[k] != v]
    if arch.layer_kinds() != kinds or wrong \
            or cfg["mamba_expand"] * arch.d_model != arch.mamba_inner \
            or not arch.gated_mlp or not arch.causal:
        raise ValueError(f"{cfg['name']}: the port's {arch.name} is not "
                         f"the file's hybrid (layers {arch.layer_kinds()}; "
                         f"fixed choices differing: {wrong})")
    return arch


def _counts(cfg) -> Tuple[int, int]:
    types = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return types.count("mamba"), types.count("attention")


def shapes(cfg: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each kind of leaf: its stacked shape and the std it is drawn with
    (0: zeros)."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    nm, na = _counts(cfg)
    hd = cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    f, fs = cfg["intermediate_size"], cfg["shared_intermediate_size"]
    e = cfg["num_local_experts"]
    h, p = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    inner = h * p
    conv = inner + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    k = cfg["mamba_d_conv"]
    out = {"embed": ((cfg["vocab_size"], d), 0.02),
           "final_norm": ((d,), 0.0),
           "norm1": ((L, d), 0.0), "norm2": ((L, d), 0.0),
           "router": ((L, d, cfg["num_router_experts"]), d ** -0.5),
           "e_gate": ((L, e, d, f), d ** -0.5),
           "e_up": ((L, e, d, f), d ** -0.5),
           "e_down": ((L, e, f, d), f ** -0.5),
           "s_gate": ((L, d, fs), d ** -0.5), "s_up": ((L, d, fs), d ** -0.5),
           "s_down": ((L, fs, d), fs ** -0.5)}
    if na:
        out.update({"wq": ((na, d, q), d ** -0.5),
                    "wk": ((na, d, kv), d ** -0.5),
                    "wv": ((na, d, kv), d ** -0.5),
                    "wo": ((na, q, d), q ** -0.5)})
    if nm:
        out.update({"in_proj": ((nm, d, inner + conv + h), d ** -0.5),
                    "conv": ((nm, k, conv), k ** -0.5),
                    "conv_bias": ((nm, conv), STDS["conv_bias"]),
                    "dt_bias": ((nm, h), STDS["dt_bias"]),
                    "A_log": ((nm, h), STDS["A_log"]),
                    "D": ((nm, h), STDS["D"]),
                    "m_norm": ((nm, inner), STDS["m_norm"]),
                    "out_proj": ((nm, inner, d), inner ** -0.5)})
    return out


MAMBA_LEAVES = {"in_proj": "in_proj", "conv": "conv",
                "conv_bias": "conv_bias", "dt_bias": "dt_bias",
                "A_log": "A_log", "D": "D", "norm": "m_norm",
                "out_proj": "out_proj"}


def program_trees(cfg: Dict[str, Any]) -> List[Any]:
    """The port's sched-layer trees with each leaf named ``(kind, index)``
    (``repro_torch.models.model.sched_layer_trees`` of its parameters)."""
    trees: List[Any] = [{"table": ("embed", None)}]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"][:cfg["num_hidden_layers"]]):
        j = seen[kind]
        seen[kind] += 1
        block = {"norm1": ("norm1", i), "norm2": ("norm2", i),
                 "moe": {"router": ("router", i), "gate": ("e_gate", i),
                         "up": ("e_up", i), "down": ("e_down", i)},
                 "shared": {"gate": ("s_gate", i), "up": ("s_up", i),
                            "down": ("s_down", i)}}
        if kind == "mamba":
            block["mamba2"] = {w: (leaf, j)
                               for w, leaf in MAMBA_LEAVES.items()}
        else:
            block["attn"] = {w: (w, j) for w in ("wq", "wk", "wv", "wo")}
        trees.append(block)
    trees.append({"norm": ("final_norm", None)})
    return trees
