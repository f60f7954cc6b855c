"""Distribution layer: DynaComm-bucketed collectives and the ZeRO trainer
(the paper's pull / push procedures as ``torch.distributed`` collectives)."""

from repro_torch.dist.collectives import (FlatSpec, flatten_tree,
                                          gather_bucket, make_flat_spec,
                                          reduce_scatter_bucket,
                                          unflatten_tree)
from repro_torch.dist.zero import ZeroTrainer, default_group

__all__ = [
    "FlatSpec", "make_flat_spec", "flatten_tree", "unflatten_tree",
    "gather_bucket", "reduce_scatter_bucket", "ZeroTrainer", "default_group",
]
