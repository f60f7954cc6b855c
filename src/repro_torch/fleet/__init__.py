"""Elastic worker fleets on a deterministic event-queue engine.

* :mod:`repro_torch.fleet.engine` — ``EventQueue``, the heap-based
  discrete-event core with stable ``(time, seq, worker)`` tie-breaking
  that the asynchronous PS trainer's loop runs on;
* :mod:`repro_torch.fleet.membership` — ``FleetSchedule`` of join / leave
  / fail / drift events, failure injection (crash mid-push, silent
  stall), and the ``FleetMembership`` roster that maps the live worker
  set onto a ``PSTopology``;
* :mod:`repro_torch.fleet.drift` — ``FleetDriftDetector``, per-worker
  EWMA drift detection over observed commit gaps;
* :mod:`repro_torch.fleet.trainer` — ``FleetTrainer``, the elastic
  bounded-staleness trainer: membership events re-plan through
  ``TopologyScheduler``, the server re-shards without losing versioned
  state, and the whole loop saves and restores bit-identically.

Everything but the engine is exported lazily, as in the reference:
``trainer`` imports ``repro_torch.ps``, which itself imports
:mod:`repro_torch.fleet.engine`, so the eager surface of this package
stays dependency-free to keep the import graph acyclic.
"""

from repro_torch.fleet.engine import Event, EventQueue

__all__ = [
    "Event", "EventQueue",
    "FAIL_MODES", "FLEET_EVENT_KINDS", "FleetEvent", "FleetMembership",
    "FleetSchedule", "WorkerSpec",
    "FleetDriftDetector",
    "FleetReplanEvent", "FleetTrainer", "MembershipChange",
]

_LAZY = {
    "FAIL_MODES": "repro_torch.fleet.membership",
    "FLEET_EVENT_KINDS": "repro_torch.fleet.membership",
    "FleetEvent": "repro_torch.fleet.membership",
    "FleetMembership": "repro_torch.fleet.membership",
    "FleetSchedule": "repro_torch.fleet.membership",
    "WorkerSpec": "repro_torch.fleet.membership",
    "FleetDriftDetector": "repro_torch.fleet.drift",
    "FleetReplanEvent": "repro_torch.fleet.trainer",
    "FleetTrainer": "repro_torch.fleet.trainer",
    "MembershipChange": "repro_torch.fleet.trainer",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch.fleet' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(module), name)
