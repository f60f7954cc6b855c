"""Parameter-Server execution: the paper's own topology.

S server shards × W edge workers, segmented parameter pulls down and
gradient pushes up over per-worker asymmetric links.  This slice of the
port runs the synchronous mode (``PSTrainer``, the ZeRO step under a
consensus plan, optionally with compressed pushes) and its run-time
re-planning trainer (``DynamicPSTrainer``); the asynchronous trainers and
the server state they use come in later slices.
"""

from repro_torch.ps.topology import (LinkModel, PSTopology, TopologySchedule,
                                     as_topology_schedule, asymmetric_link,
                                     uplink_degradation)
from repro_torch.ps.worker import PSTrainer
from repro_torch.ps.dynamic import DynamicPSTrainer

__all__ = [
    "LinkModel", "PSTopology", "asymmetric_link",
    "TopologySchedule", "as_topology_schedule", "uplink_degradation",
    "PSTrainer", "DynamicPSTrainer",
]
