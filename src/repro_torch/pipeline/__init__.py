"""repro_torch.pipeline: stage-partitioned pipeline-parallel training.

The DynaComm treatment of pipeline parallelism, in PyTorch: stages come
from the same family of DPs as the paper's transmission schedules
(:func:`repro_torch.core.dp.dp_partition`), micro-batch orders are
explicit deterministic event streams (:mod:`repro_torch.pipeline.schedule`),
and the inter-stage activation traffic is scheduled through the existing
push/pull cost model — each boundary is a virtual layer stack that
``dp_forward``/``dp_backward`` segment to overlap with stage compute
(:mod:`repro_torch.pipeline.transfer`).  The partition, schedule and
transfer modules are plain Python and give the JAX package's results
exactly.  :class:`PipelineTrainer` executes the result in one process,
stage by stage on the host, with boundary buffers handed between stage
devices and per-layer VJPs; its losses are bitwise equal across stage
counts at one micro-batch.
"""

from repro_torch.pipeline.partition import (StagePartition, partition_loads,
                                            partition_profiles)
from repro_torch.pipeline.schedule import (BACKWARD, FORWARD, SCHEDULES,
                                           PipelineSchedule, PipelineTimeline,
                                           StageTask, analytic_bubble_fraction,
                                           gpipe_schedule, make_schedule,
                                           one_f_one_b_schedule, simulate)
from repro_torch.pipeline.trainer import EMBED_LINK, PipelineTrainer
from repro_torch.pipeline.transfer import (TransferPlan, boundary_costs,
                                           plan_boundary,
                                           whole_tensor_decision)

__all__ = [
    "BACKWARD",
    "EMBED_LINK",
    "FORWARD",
    "PipelineSchedule",
    "PipelineTimeline",
    "PipelineTrainer",
    "SCHEDULES",
    "StagePartition",
    "StageTask",
    "TransferPlan",
    "analytic_bubble_fraction",
    "boundary_costs",
    "gpipe_schedule",
    "make_schedule",
    "one_f_one_b_schedule",
    "partition_loads",
    "partition_profiles",
    "plan_boundary",
    "simulate",
    "whole_tensor_decision",
]
