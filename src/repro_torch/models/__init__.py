"""Model zoo (text models with attention blocks; other families later)."""

from repro_torch.models.model import (cross_entropy, forward, init_params,
                                      num_sched_layers, param_count,
                                      param_shapes, params_from_sched_layers,
                                      sched_layer_bytes, sched_layer_trees,
                                      train_loss, tree_bytes)
from repro_torch.models.profiles import (block_forward_flops, layer_profiles,
                                         model_flops_per_token)

__all__ = [
    "init_params", "forward", "train_loss", "cross_entropy",
    "num_sched_layers", "sched_layer_trees", "params_from_sched_layers",
    "sched_layer_bytes", "tree_bytes", "param_count", "param_shapes",
    "layer_profiles", "block_forward_flops", "model_flops_per_token",
]
