"""Parameter-Server execution: the paper's own topology.

S server shards × W edge workers, segmented parameter pulls down and
gradient pushes up over per-worker asymmetric links, synchronously
(``PSTrainer``: the ZeRO step under a consensus plan, optionally with
compressed pushes) or asynchronously under a bounded staleness ``k``
(``AsyncPSTrainer`` over the versioned ``PSServer``, with server-side
rejection or SSP wait-at-barrier throttling and optional BSP
aggregation).

``TopologySchedule`` makes the fabric time-varying, and the
``repro_torch.ps.dynamic`` trainers re-derive the decomposition once per
topology epoch — the paper's run-time loop in the PS regime.
"""

from repro_torch.ps.async_mode import (THROTTLES, AsyncPSTrainer,
                                       AsyncPushEvent, AsyncRunLog)
from repro_torch.ps.dynamic import (AsyncRescheduleEvent,
                                    DynamicAsyncPSTrainer, DynamicPSTrainer,
                                    profiles_from_specs)
from repro_torch.ps.server import (PSServer, PushResult, StaleVersion,
                                   TransferLedger)
from repro_torch.ps.topology import (LinkModel, PSTopology, TopologySchedule,
                                     as_topology_schedule, asymmetric_link,
                                     uplink_degradation)
from repro_torch.ps.worker import PSTrainer

__all__ = [
    "LinkModel", "PSTopology", "asymmetric_link",
    "TopologySchedule", "as_topology_schedule", "uplink_degradation",
    "PSServer", "PushResult", "StaleVersion", "TransferLedger",
    "PSTrainer",
    "THROTTLES", "AsyncPSTrainer", "AsyncPushEvent", "AsyncRunLog",
    "AsyncRescheduleEvent", "DynamicAsyncPSTrainer", "DynamicPSTrainer",
    "profiles_from_specs",
]
