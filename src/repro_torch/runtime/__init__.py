"""One Trainer API over the ported execution regimes (``local``, ``zero``,
``ps``, ``dynamic``, ``dynamic-ps``, ``ps-async``, ``dynamic-ps-async``).

A frozen, JSON-round-trippable :class:`RuntimeConfig` (the reference's
schema, so the checked-in smoke configs load unchanged) names a registered
runtime, and :func:`build_runtime` turns it into an object implementing
the :class:`Trainer` protocol — on the first CUDA device unless the caller
passes ``device="cpu"``.
"""

from repro_torch.runtime.config import (DYNAMIC_RUNTIMES, RUNTIME_REGIMES,
                                        CompressionConfig, ExecutionConfig,
                                        FleetConfig, FleetEventConfig,
                                        MeasureConfig, NetworkConfig,
                                        PipelineConfig, RuntimeConfig,
                                        ScheduleConfig, TopologyConfig)
from repro_torch.runtime.protocol import EvalEvent, Trainer
from repro_torch.runtime.registry import (RUNTIMES, build_runtime,
                                          register_runtime, resolve_device,
                                          runtime_names)

__all__ = [
    "RuntimeConfig", "ScheduleConfig", "ExecutionConfig", "MeasureConfig",
    "NetworkConfig", "TopologyConfig", "CompressionConfig",
    "FleetConfig", "FleetEventConfig", "PipelineConfig",
    "RUNTIME_REGIMES", "DYNAMIC_RUNTIMES", "Trainer", "EvalEvent",
    "build_runtime", "register_runtime", "resolve_device", "runtime_names",
    "RUNTIMES",
]
