"""DynaComm core: the paper's contribution (scheduling) as a library.

A copy of the reference package's ``core``, so that plans, profiles and
planner caches equal the reference's.
"""

from repro_torch.core.costmodel import (LayerCosts, Segment, TopologyCosts,
                                  backward_time, forward_time, iteration_time)
from repro_torch.core.dp import (DPResult, PartitionResult, dp_backward, dp_forward,
                           dp_partition, dynacomm_schedule)
from repro_torch.core.greedy import ibatch_backward, ibatch_forward, ibatch_schedule
from repro_torch.core.baselines import (lbl_backward, lbl_forward,
                                  sequential_backward, sequential_forward)
from repro_torch.core.bruteforce import bruteforce_backward, bruteforce_forward
from repro_torch.core.scheduler import (STRATEGIES, Decision, DynaCommScheduler,
                                  TopologyScheduler, consensus_decision,
                                  evaluate, schedule, schedule_topology)
from repro_torch.core.planner import AsyncPlanner, Planner, PlannerStats, cost_key
from repro_torch.core.buckets import (BucketPlan, decision_from_plan,
                                plan_from_decision)
from repro_torch.core.profiler import (EwmaDriftDetector, LayerProfile,
                                 LayerTimingHook, costs_from_profiles,
                                 measure_layer_costs, random_costs)
from repro_torch.core.netmodel import (EdgeNetworkModel, NetworkSchedule,
                                 TPUSystemModel, TPU_HBM_BW,
                                 TPU_ICI_BW_PER_LINK, TPU_PEAK_FLOPS_BF16,
                                 as_schedule, bandwidth_shift)
from repro_torch.core.simulator import (IterationTimeline, PSReplanTimeline,
                                  PSTimeline, check_partial_orders,
                                  simulate_backward, simulate_forward,
                                  simulate_iteration, simulate_ps_iteration,
                                  simulate_ps_replan)

__all__ = [
    "LayerCosts", "Segment", "TopologyCosts",
    "forward_time", "backward_time", "iteration_time",
    "DPResult", "PartitionResult", "dp_forward", "dp_backward",
    "dp_partition", "dynacomm_schedule",
    "ibatch_forward", "ibatch_backward", "ibatch_schedule",
    "lbl_forward", "lbl_backward", "sequential_forward", "sequential_backward",
    "bruteforce_forward", "bruteforce_backward",
    "STRATEGIES", "Decision", "DynaCommScheduler", "TopologyScheduler",
    "evaluate", "schedule", "schedule_topology", "consensus_decision",
    "AsyncPlanner", "Planner", "PlannerStats", "cost_key",
    "BucketPlan", "plan_from_decision", "decision_from_plan",
    "EwmaDriftDetector", "LayerProfile", "LayerTimingHook",
    "costs_from_profiles", "measure_layer_costs", "random_costs",
    "EdgeNetworkModel", "NetworkSchedule", "TPUSystemModel",
    "as_schedule", "bandwidth_shift",
    "TPU_HBM_BW", "TPU_ICI_BW_PER_LINK", "TPU_PEAK_FLOPS_BF16",
    "IterationTimeline", "PSReplanTimeline", "PSTimeline",
    "simulate_forward", "simulate_backward", "simulate_iteration",
    "simulate_ps_iteration", "simulate_ps_replan", "check_partial_orders",
]
