"""The granite decoders (dense and MoE) as the port runs them: a causal
SwiGLU decoder of global GQA attention, tied head.

Leaves are named ``(kind, layer)``: ``("wq", 3)`` is layer 3's query
projection, ``("embed", None)`` the token table (tied head).  Dense
weights are ``(in, out)``; norm scales start at zero (the models scale
by ``1 + scale``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from portbench.counts import model_flops as flops  # noqa: F401

# configuration-file key -> the port's ArchConfig field
ARCH_FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
               "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads",
               "head_dim": "head_dim", "intermediate_size": "d_ff",
               "vocab_size": "vocab_size", "rope_theta": "rope_theta",
               "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "num_local_experts": "num_experts",
               "num_experts_per_tok": "top_k",
               "capacity_factor": "capacity_factor"}


def arch_for(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` named by the file (``arch``), with the
    file's ``program_overrides`` (test-size files only); every size the
    configuration as run states must be the one the port runs."""
    from repro_torch.configs import get_config
    arch = get_config(cfg["arch"])
    if cfg.get("program_overrides"):
        arch = dataclasses.replace(arch, **cfg["program_overrides"])
    for key, field in ARCH_FIELDS.items():
        want = cfg.get(key, 0 if key in ("num_local_experts",
                                         "num_experts_per_tok") else None)
        if want is None:
            continue
        have = getattr(arch, field)
        if key == "capacity_factor" and not arch.is_moe:
            continue
        if have != want:
            raise ValueError(f"{cfg['name']}: the file states {key} = "
                             f"{want!r}, the port's {arch.name} runs "
                             f"{field} = {have!r}")
    if arch.activation != cfg["hidden_act"] or not arch.gated_mlp \
            or arch.layer_pattern != ("global_attn",) or not arch.causal:
        raise ValueError(f"{cfg['name']}: the port's {arch.name} is not a "
                         f"causal SwiGLU decoder of global attention")
    return arch


def shapes(cfg: Dict[str, Any]) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Each kind of leaf: its stacked shape and the std it is drawn with
    (0: zeros)."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hd = cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    f = cfg["intermediate_size"]
    out = {"embed": ((cfg["vocab_size"], d), 0.02),
           "norm1": ((L, d), 0.0), "norm2": ((L, d), 0.0),
           "final_norm": ((d,), 0.0),
           "wq": ((L, d, q), d ** -0.5), "wk": ((L, d, kv), d ** -0.5),
           "wv": ((L, d, kv), d ** -0.5), "wo": ((L, q, d), q ** -0.5)}
    if cfg.get("num_local_experts", 0):
        e = cfg["num_local_experts"]
        out.update({"router": ((L, d, e), d ** -0.5),
                    "e_gate": ((L, e, d, f), d ** -0.5),
                    "e_up": ((L, e, d, f), d ** -0.5),
                    "e_down": ((L, e, f, d), f ** -0.5)})
    else:
        out.update({"gate": ((L, d, f), d ** -0.5),
                    "up": ((L, d, f), d ** -0.5),
                    "down": ((L, f, d), f ** -0.5)})
    return out


def program_trees(cfg: Dict[str, Any]) -> List[Any]:
    """The port's sched-layer trees with each leaf named ``(kind, layer)``
    (``repro_torch.models.model.sched_layer_trees`` of its parameters)."""
    moe = bool(cfg.get("num_local_experts", 0))
    trees: List[Any] = [{"table": ("embed", None)}]
    for i in range(cfg["num_hidden_layers"]):
        block = {"norm1": ("norm1", i), "norm2": ("norm2", i),
                 "attn": {w: (w, i) for w in ("wq", "wk", "wv", "wo")}}
        if moe:
            block["moe"] = {"router": ("router", i), "gate": ("e_gate", i),
                            "up": ("e_up", i), "down": ("e_down", i)}
        else:
            block["mlp"] = {w: (w, i) for w in ("gate", "up", "down")}
        trees.append(block)
    trees.append({"norm": ("final_norm", None)})
    return trees
