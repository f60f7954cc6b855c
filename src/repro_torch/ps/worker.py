"""Worker-side synchronous PS trainer.

``PSTrainer`` executes a ``BucketPlan`` in the parameter-server topology's
synchronous mode: every iteration, each worker pulls each forward
segment's parameters down (one transmission per segment), runs forward +
backward, and pushes each backward segment's gradients up (one
transmission per segment); the server applies the summed gradients and
all workers observe the new version at the barrier.

On a process group this maps exactly onto the bucketed ZeRO step: place
server shard *s*'s partition of every layer buffer on rank *s* (server
shards co-located with workers, the standard sharded-PS deployment), and
a segment pull **is** one all-gather, a segment push **is** one
reduce-scatter, and the server-side optimizer apply **is** the sharded
update on local partitions.  ``PSTrainer`` therefore drives a contained
:class:`repro_torch.dist.zero.ZeroTrainer` for the data path — which makes
sync-mode losses *bit-identical* to the ZeRO trainer under the same plan —
and layers the PS semantics on top: per-topology scheduling (per-worker
fc/bc, per-link asymmetric pt/gt/Δt), per-segment transfer accounting
against the topology's links, and the PS timeline view.  A compressor
rides along: the plan is priced on its wire bytes and the ZeRO step
pushes its round-tripped gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.buckets import (BucketPlan, decision_from_plan,
                                      plan_from_decision)
from repro_torch.core.costmodel import TopologyCosts
from repro_torch.core.scheduler import consensus_decision
from repro_torch.core.simulator import PSTimeline, simulate_ps_iteration
from repro_torch.dist.collectives import bucket_bytes
from repro_torch.dist.zero import ZeroTrainer, default_group
from repro_torch.models import model as model_lib
from repro_torch.models.profiles import layer_profiles
from repro_torch.optim import Optimizer
from repro_torch.ps.topology import PSTopology


@dataclasses.dataclass
class PSTrainer:
    """Synchronous segmented-push/pull trainer over a PS topology."""

    cfg: ArchConfig
    plan: BucketPlan
    optimizer: Optimizer
    topology: PSTopology
    device: Any
    group: Optional[Any] = None
    zero3: bool = False
    aux_weight: float = 0.01
    compressor: Optional[Any] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.group is None:
            self.group = default_group(self.device)
        ranks = dist.get_world_size(self.group)
        if self.topology.num_workers != ranks:
            raise ValueError(
                f"topology has {self.topology.num_workers} workers but the "
                f"process group has {ranks} ranks — synchronous PS runs "
                f"one worker per rank")
        # the data path: co-located server shards make pull/push
        # collectives (module docstring) — delegate to the ZeRO step
        self._zero = ZeroTrainer(cfg=self.cfg, plan=self.plan,
                                 optimizer=self.optimizer, device=self.device,
                                 group=self.group, zero3=self.zero3,
                                 aux_weight=self.aux_weight,
                                 compressor=self.compressor)
        self.compressor = self._zero.compressor   # scheme "none" → None
        self.specs = self._zero.specs
        self.num_layers = self._zero.num_layers
        self.axis_size = self._zero.axis_size
        self.rank = self._zero.rank

    # ------------------------------------------------------------------
    # construction from a topology (profile → consensus plan → trainer)
    # ------------------------------------------------------------------

    @classmethod
    def from_topology(cls, cfg: ArchConfig, topology: PSTopology,
                      optimizer: Optimizer, input_shape: InputShape, *,
                      device: Any, strategy: str = "dynacomm",
                      compressor: Optional[Any] = None,
                      **kwargs) -> "PSTrainer":
        """Schedule against the topology and build the trainer.

        Synchronous mode needs one shared plan; the consensus decision
        minimizes the straggler's iteration time (see
        ``core.scheduler.consensus_decision``).  A ``compressor`` is
        threaded into the plan search (pushes are timed on wire bytes, so
        the DP re-segments) and into the execution path."""
        topo_costs = topology.topology_costs(layer_profiles(cfg, input_shape),
                                             compressor=compressor)
        decision, _ = consensus_decision(topo_costs, strategy)
        plan = plan_from_decision(*decision, model_lib.num_sched_layers(cfg))
        return cls(cfg=cfg, plan=plan, optimizer=optimizer,
                   topology=topology, device=device, compressor=compressor,
                   **kwargs)

    def with_plan(self, plan: BucketPlan) -> "PSTrainer":
        return dataclasses.replace(self, plan=plan)

    # ------------------------------------------------------------------
    # the data path (delegated; see module docstring)
    # ------------------------------------------------------------------

    def init_state(self, gen) -> Dict[str, Any]:
        return self._zero.init_state(gen)

    def step(self, state, batch):
        """One training step with one pull + one push collective per plan
        segment; returns ``(state, mean loss)``."""
        return self._zero.step(state, batch)

    def params_from_state(self, state) -> Any:
        return self._zero.params_from_state(state)

    def state_from_flats(self, *args, **kwargs) -> Dict[str, Any]:
        return self._zero.state_from_flats(*args, **kwargs)

    def global_state(self, state) -> Dict[str, Any]:
        return self._zero.global_state(state)

    def local_state(self, whole) -> Dict[str, Any]:
        return self._zero.local_state(whole)

    # ------------------------------------------------------------------
    # PS accounting: segments → shards, bytes → links
    # ------------------------------------------------------------------

    @property
    def expected_transfers(self) -> Tuple[int, int]:
        """(pulls, pushes) per iteration == (all-gathers, reduce-scatters)
        of the step: one of each per segment."""
        return (self.plan.num_forward_collectives,
                self.plan.num_backward_collectives)

    def segment_bytes(self, bucket) -> int:
        """Unpadded f32 payload of one segment's message."""
        return bucket_bytes(self.specs, bucket)

    def segment_owners(self) -> Dict[str, Tuple[int, ...]]:
        """Owning server shard per plan segment, both directions."""
        L = self.num_layers
        return {
            "forward": tuple(self.topology.owner_of_bucket(b, L)
                             for b in self.plan.forward),
            "backward": tuple(self.topology.owner_of_bucket(b, L)
                              for b in self.plan.backward),
        }

    def transfer_bytes(self) -> Dict[str, int]:
        """Per-iteration logical fp32 bytes each worker moves per
        direction."""
        return {
            "pull": sum(self.segment_bytes(b) for b in self.plan.forward),
            "push": sum(self.segment_bytes(b) for b in self.plan.backward),
        }

    def segment_wire_bytes(self, bucket) -> int:
        """Bytes one segment's push puts on the uplink (compressed
        per-layer payloads + per-segment header)."""
        if self.compressor is None:
            return self.segment_bytes(bucket)
        wire = sum(float(self.compressor.wire_bytes(self.specs[l].total * 4))
                   for l in bucket)
        return int(round(wire + self.compressor.segment_overhead_bytes))

    def transfer_wire_bytes(self) -> Dict[str, int]:
        """Per-iteration *wire* bytes per direction (pulls stay fp32)."""
        return {
            "pull": sum(self.segment_bytes(b) for b in self.plan.forward),
            "push": sum(self.segment_wire_bytes(b)
                        for b in self.plan.backward),
        }

    # ------------------------------------------------------------------
    # scheduling / simulation views
    # ------------------------------------------------------------------

    def topology_costs(self, input_shape: InputShape) -> TopologyCosts:
        return self.topology.topology_costs(
            layer_profiles(self.cfg, input_shape),
            compressor=self.compressor)

    def timeline_from_costs(self, costs: TopologyCosts) -> PSTimeline:
        """Per-worker timeline of one synchronous iteration of *this
        trainer's* plan under explicit costs (e.g. a topology epoch's
        projection a caller already holds), skipping the profile
        re-derivation that :meth:`timeline` performs."""
        return simulate_ps_iteration(costs, decision_from_plan(self.plan))

    def timeline(self, input_shape: InputShape) -> PSTimeline:
        """Per-worker timeline of one synchronous iteration of the plan."""
        return self.timeline_from_costs(self.topology_costs(input_shape))

    def estimated_step_seconds(self, input_shape: InputShape) -> float:
        return self.timeline(input_shape).makespan
