"""DeepSeek-V3-style models (``deepseek_v3``) as the port runs them:
multi-head latent attention in every layer, the leading
``first_k_dense_replace`` layers with a dense SwiGLU, the rest with an MoE
MLP (this device's share of the routed experts, sigmoid routing with a
correction bias) and the shared experts as one SwiGLU, and an untied head.

Leaves are named ``(kind, index)``.  A kind every layer has is indexed by
the layer (``("wq", 3)``); the dense MLP's kinds by the layer's place
among the dense layers (``("d_up", 0)``), the MoE's by its place among the
MoE layers (``("router", 0)``: layer 1's), as
``portbench/reference/deepseek_v3.py`` holds them.  Dense weights are
``(in, out)``; norm scales are drawn as zeros (the models scale by
``1 + scale``).

The configuration file holds the source's keys; ``n_routed_experts`` is
the experts this device holds from ``first_local_expert`` on (also
``num_local_experts``, the harness's key), ``num_router_experts`` the
router's width, and ``vocab_size`` this device's slice of the vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from portbench.counts import deepseek_v3_flops as flops  # noqa: F401

# configuration-file key -> the port's ArchConfig field
ARCH_FIELDS = {"hidden_size": "d_model",
               "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads",
               "head_dim": "head_dim",
               "moe_intermediate_size": "d_ff",
               "intermediate_size": "dense_d_ff",
               "first_k_dense_replace": "first_dense_layers",
               "vocab_size": "vocab_size", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "num_router_experts": "num_experts",
               "num_experts_per_tok": "top_k",
               "capacity_factor": "capacity_factor",
               "kv_lora_rank": "kv_lora_rank",
               "qk_nope_head_dim": "qk_nope_head_dim",
               "qk_rope_head_dim": "qk_rope_head_dim",
               "v_head_dim": "v_head_dim", "rope_theta": "rope_theta",
               "scoring_func": "router_scoring",
               "routed_scaling_factor": "routed_scaling",
               "seq_aux": "seq_aux"}
# the published layer's fixed choices, which the port's model makes
FIXED = {"hidden_act": "silu", "attention_bias": False,
         "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
         "norm_topk_prob": True, "q_lora_rank": None, "moe_layer_freq": 1,
         "num_nextn_predict_layers": 0, "router_bias_update": "none"}

# the std of each drawn kind that is not a dense weight or a norm.  The
# model scales its embedding by nothing, so the table is drawn at the
# scale of the branches' outputs: at 0.02 the residual stream after layer
# 0 is the attention's average over the prefix, nearly one vector for
# every token, and the routers send most tokens to the same experts (some
# held experts to none).  The correction bias stands for one that training
# has moved, so that it changes the chosen experts of a share of the
# tokens (the configuration file's ``assumed``).
STDS = {"embed": 1.0, "router_bias": 0.01}


# The program's routing in the steps the reference follows: each call of
# the port's ``repro_torch.models.moe.route`` (a forward and a recompute a
# MoE layer a step), its chosen experts ``(N, k)`` and its keep flags
# ``(N k,)``, in call order.  The reference decides a near-tie of its own
# top k as the program did (``portbench/reference/deepseek_v3.py``).
ROUTED: List[Tuple[Any, Any]] = []
RECORDED_STEPS = 3          # the cells' check_steps


def record_routing(calls: int) -> None:
    """Record the port's next ``calls`` routings into ``ROUTED`` (cleared
    first), then hand ``moe.route`` back: the MoE layer gets the same
    routing, and the steps after the recorded ones run the port's own
    function."""
    import torch
    from repro_torch.models import moe
    route = getattr(moe.route, "recording", moe.route)
    ROUTED.clear()
    moe.route = route
    if calls <= 0:
        return

    def recorded(probs, arch, cap):
        r = route(probs, arch, cap)
        ROUTED.append((r.top_e.to(torch.int16), r.keep.clone()))
        if len(ROUTED) >= calls and moe.route is recorded:
            moe.route = route
        return r
    recorded.recording = route
    moe.route = recorded


def arch_for(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` named by the file (``arch``) cut to the
    file's expert share and vocabulary slice, with the file's
    ``program_overrides`` (test-size files only); every size and choice
    the configuration as run states must be the one the port runs.  As
    the benchmark builds the program from it, this also records the
    routing of the program's first ``RECORDED_STEPS`` steps
    (``record_routing``)."""
    from repro_torch.configs import get_config
    cut = {"num_layers": cfg["num_hidden_layers"],
           "experts_first": cfg["first_local_expert"],
           "experts_held": cfg["n_routed_experts"],
           "vocab_size": cfg["vocab_size"]}
    arch = dataclasses.replace(get_config(cfg["arch"]),
                               **{**cut, **cfg.get("program_overrides", {})})
    for key, field in ARCH_FIELDS.items():
        if getattr(arch, field) != cfg[key]:
            raise ValueError(f"{cfg['name']}: the file states {key} = "
                             f"{cfg[key]!r}, the port's {arch.name} runs "
                             f"{field} = {getattr(arch, field)!r}")
    wrong = [k for k, v in FIXED.items() if cfg[k] != v]
    if wrong or set(arch.layer_kinds()) != {"mla"} \
            or cfg["num_local_experts"] != cfg["n_routed_experts"] \
            or arch.shared_d_ff != cfg["n_shared_experts"] \
            * cfg["moe_intermediate_size"] \
            or arch.head_dim != cfg["qk_nope_head_dim"] \
            + cfg["qk_rope_head_dim"] \
            or arch.embedding_multiplier != 1.0 \
            or arch.attention_multiplier is not None \
            or arch.residual_multiplier != 1.0 \
            or arch.logits_scaling != 1.0 or not arch.gated_mlp \
            or not arch.causal or arch.position_embedding != "rope":
        raise ValueError(f"{cfg['name']}: the port's {arch.name} is not "
                         f"the file's model (fixed choices differing: "
                         f"{wrong})")
    record_routing(2 * counts(cfg)[1] * RECORDED_STEPS)
    return arch


def counts(cfg: Dict[str, Any]) -> Tuple[int, int]:
    """(dense layers, MoE layers)."""
    dense = min(cfg["first_k_dense_replace"], cfg["num_hidden_layers"])
    return dense, cfg["num_hidden_layers"] - dense


def shapes(cfg: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each kind of leaf: its stacked shape and the std it is drawn with
    (0: zeros)."""
    L, d, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    nd, nm = counts(cfg)
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    out = {"embed": ((v, d), STDS["embed"]), "head": ((d, v), d ** -0.5),
           "final_norm": ((d,), 0.0),
           "norm1": ((L, d), 0.0), "norm2": ((L, d), 0.0),
           "wq": ((L, d, h * (dn + dr)), d ** -0.5),
           "wkv_a": ((L, d, r + dr), d ** -0.5),
           "kv_norm": ((L, r), 0.0),
           "wkv_b": ((L, r, h * (dn + dv)), r ** -0.5),
           "wo": ((L, h * dv, d), (h * dv) ** -0.5)}
    if nd:
        f = cfg["intermediate_size"]
        out.update({"d_gate": ((nd, d, f), d ** -0.5),
                    "d_up": ((nd, d, f), d ** -0.5),
                    "d_down": ((nd, f, d), f ** -0.5)})
    if nm:
        e, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        fs = cfg["n_shared_experts"] * f
        out.update({"router": ((nm, d, cfg["num_router_experts"]),
                               d ** -0.5),
                    "router_bias": ((nm, cfg["num_router_experts"]),
                                    STDS["router_bias"]),
                    "e_gate": ((nm, e, d, f), d ** -0.5),
                    "e_up": ((nm, e, d, f), d ** -0.5),
                    "e_down": ((nm, e, f, d), f ** -0.5),
                    "s_gate": ((nm, d, fs), d ** -0.5),
                    "s_up": ((nm, d, fs), d ** -0.5),
                    "s_down": ((nm, fs, d), fs ** -0.5)})
    return out


MLA_LEAVES = ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")


def program_trees(cfg: Dict[str, Any]) -> List[Any]:
    """The port's sched-layer trees with each leaf named ``(kind, index)``
    (``repro_torch.models.model.sched_layer_trees`` of its parameters)."""
    nd, _ = counts(cfg)
    trees: List[Any] = [{"table": ("embed", None)}]
    for i in range(cfg["num_hidden_layers"]):
        block = {"norm1": ("norm1", i), "norm2": ("norm2", i),
                 "mla": {w: (w, i) for w in MLA_LEAVES}}
        if i < nd:
            block["mlp"] = {w: ("d_" + w, i) for w in ("gate", "up", "down")}
        else:
            j = i - nd
            block["moe"] = {"router": ("router", j),
                            "bias": ("router_bias", j),
                            "gate": ("e_gate", j), "up": ("e_up", j),
                            "down": ("e_down", j)}
            block["shared"] = {w: ("s_" + w, j)
                               for w in ("gate", "up", "down")}
        trees.append(block)
    trees.append({"norm": ("final_norm", None), "head": ("head", None)})
    return trees
