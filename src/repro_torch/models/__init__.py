"""Model zoo: every family of ``configs/`` (attention, RG-LRU, xLSTM and
MoE blocks; text, stub audio and stub vision frontends), and the paper's
CNN workload tables with its trainable small CNN."""

from repro_torch.models.model import (cross_entropy, decode_step, forward,
                                      init_caches, init_params,
                                      num_sched_layers, param_count,
                                      param_shapes, params_from_sched_layers,
                                      sched_layer_bytes, sched_layer_trees,
                                      train_loss, tree_bytes)
from repro_torch.models.profiles import (block_forward_flops, layer_profiles,
                                         model_flops_per_token)
from repro_torch.models.cnn import (PAPER_CNNS, small_cnn_forward,
                                    small_cnn_init, small_cnn_loss)

__all__ = [
    "init_params", "forward", "train_loss", "decode_step", "init_caches",
    "cross_entropy",
    "num_sched_layers", "sched_layer_trees", "params_from_sched_layers",
    "sched_layer_bytes", "tree_bytes", "param_count", "param_shapes",
    "layer_profiles", "block_forward_flops", "model_flops_per_token",
    "PAPER_CNNS", "small_cnn_init", "small_cnn_forward", "small_cnn_loss",
]
