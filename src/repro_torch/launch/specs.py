"""Shape stand-ins for every model input: tensors on the ``meta`` device.

The reference returns ``jax.ShapeDtypeStruct``s; a ``meta`` tensor is the
port's counterpart (a shape and a dtype, no storage).  Tokens and labels
are int64, the port's batch dtype (the reference's are int32, equal in
value; ``data/pipeline.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import model as model_lib

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The batch of a train or prefill step (global batch)."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio":
        batch = {"frames": _spec((b, t, cfg.d_model), dtype)}
    elif cfg.frontend == "vision":
        nv = min(cfg.num_vision_tokens, t - 1)
        batch = {"tokens": _spec((b, t - nv), torch.int64),
                 "vision_embeds": _spec((b, nv, cfg.d_model), dtype)}
    else:
        batch = {"tokens": _spec((b, t), torch.int64)}
    if shape.mode == "train":
        lab_t = batch["tokens"].shape[1] if "tokens" in batch else t
        batch["labels"] = _spec((b, lab_t), torch.int64)
    return batch


def state_specs(cfg: ArchConfig, optimizer, dtype=torch.bfloat16
                ) -> Tuple[Any, Any]:
    """(params, opt_state) on ``meta``; the optimizer's moments shaped like
    the parameters (the reference's ``OptState`` of trees)."""
    from repro_torch.train.loop import opt_tree
    params = model_lib.init_params(cfg, None, dtype, META)
    return params, opt_tree(optimizer.init(tree.leaves(params)), params)


def cache_specs(cfg: ArchConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Any:
    """Per-layer decode caches sized for ``shape.seq_len``."""
    return model_lib.init_caches(cfg, shape.global_batch, shape.seq_len,
                                 dtype, META)


def decode_specs(cfg: ArchConfig, shape: InputShape, dtype=torch.bfloat16):
    """(token (B, 1) int64, caches)."""
    return _spec((shape.global_batch, 1), torch.int64), \
        cache_specs(cfg, shape, dtype)
