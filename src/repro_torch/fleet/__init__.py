"""Deterministic discrete-event engine of the fleet layer.

``EventQueue`` orders the asynchronous PS trainer's completions by
``(simulated time, insertion seq, worker id)``.  The elastic fleet
(membership, drift detection and ``FleetTrainer``) comes in a later slice
of the port.
"""

from repro_torch.fleet.engine import Event, EventQueue

__all__ = ["Event", "EventQueue"]
