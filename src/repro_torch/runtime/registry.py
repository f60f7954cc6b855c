"""The runtime registry: name → builder, and the one factory entry point.

``@register_runtime("zero", description=...)`` on an adapter class makes it
buildable from a :class:`~repro_torch.runtime.config.RuntimeConfig` whose
``runtime`` field carries that name; :func:`build_runtime` is the single
construction path every launcher goes through.  This slice of the port
registers ``local`` and ``zero``; the other names of the schema raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.runtime.config import RUNTIME_REGIMES, RuntimeConfig
from repro_torch.runtime.protocol import Trainer

RUNTIMES: Dict[str, "RuntimeSpec"] = {}


@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """One registered runtime."""

    name: str
    regime: str                    # local | zero | ps-sync | ps-async
    description: str
    builder: Callable[..., Trainer]


def register_runtime(name: str, *, description: str = ""
                     ) -> Callable[[Callable], Callable]:
    """Class decorator registering a runtime builder under ``name``.

    The decorated callable is invoked as ``builder(config, arch, batch_fn,
    device)`` and must return a :class:`Trainer`.
    """
    if name not in RUNTIME_REGIMES:
        raise ValueError(f"runtime {name!r} is not a known name; add it to "
                         f"repro_torch.runtime.config.RUNTIME_REGIMES first")

    def deco(builder):
        if name in RUNTIMES:
            raise ValueError(f"runtime {name!r} registered twice")
        RUNTIMES[name] = RuntimeSpec(name=name,
                                     regime=RUNTIME_REGIMES[name],
                                     description=description,
                                     builder=builder)
        return builder

    return deco


def runtime_names() -> Tuple[str, ...]:
    """Every registered runtime name, sorted."""
    _ensure_registered()
    return tuple(sorted(RUNTIMES))


def _ensure_registered() -> None:
    from repro_torch.runtime import adapters  # noqa: F401  (registers)


def _as_config(config) -> RuntimeConfig:
    if isinstance(config, RuntimeConfig):
        return config
    if isinstance(config, dict):
        return RuntimeConfig.from_dict(config)
    if isinstance(config, str):
        return RuntimeConfig.from_json(config)
    raise TypeError(f"config must be a RuntimeConfig, dict, or JSON "
                    f"string, got {type(config).__name__}")


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the current CUDA device; without a card
    and without an explicit device this raises instead of taking the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; repro_torch runs "
                           "on the card by default — pass device='cpu' (or "
                           "--device cpu) to run the plain PyTorch path on "
                           "the host")
    return torch.device("cuda", torch.cuda.current_device())


def build_runtime(config, model: Optional[Any] = None,
                  data: Optional[Any] = None, device=None) -> Trainer:
    """Build the configured runtime: the factory behind every launcher.

    Parameters
    ----------
    config:
        a :class:`RuntimeConfig` (or a dict / JSON string of one).
    model:
        an ``ArchConfig`` (or arch name) overriding ``config.arch``;
        ``None`` resolves ``config.arch`` (reduced per ``config.reduced``).
    data:
        a ``batch_fn(i) -> batch`` callable or a pipeline exposing
        ``.batch(i)``; ``None`` builds the deterministic
        ``SyntheticText`` stream from the config.
    device:
        where the runtime runs; ``None`` is the current CUDA device.
    """
    config = _as_config(config)
    _ensure_registered()
    if config.runtime not in RUNTIMES:
        raise ValueError(f"runtime {config.runtime!r} is not ported to "
                         f"repro_torch yet (ported: {sorted(RUNTIMES)}); "
                         f"see ROADMAP queue 1")
    device = resolve_device(device)

    from repro_torch.configs import get_config
    if model is None:
        arch = get_config(config.arch)
        if config.reduced:
            arch = arch.reduced()
    elif isinstance(model, str):
        arch = get_config(model)
        if config.reduced:
            arch = arch.reduced()
    else:
        arch = model

    if data is None:
        from repro_torch.data.pipeline import SyntheticText
        batch_fn = SyntheticText(arch.vocab_size, config.seq, config.batch,
                                 seed=config.seed).batch
    elif callable(data):
        batch_fn = data
    elif hasattr(data, "batch"):
        batch_fn = data.batch
    else:
        raise TypeError(f"data must be a batch_fn or expose .batch(i), "
                        f"got {type(data).__name__}")

    return RUNTIMES[config.runtime].builder(config, arch, batch_fn, device)
