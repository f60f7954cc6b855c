"""Runtime adapters: the ported trainers behind one ``Trainer`` protocol.

Each adapter owns everything a regime needs to run — device, optimizer,
model/arch config, trainer, training state, transfer accounting — and
presents the uniform protocol surface (``fit`` / ``step`` / ``events`` /
``timeline`` / ``ledger`` / ``save_state`` / ``restore_state``).  The
underlying trainer stays reachable as ``.trainer``.

This slice ports ``local`` (whole-model autograd, no collectives) and
``zero`` (the DynaComm-bucketed ZeRO step).  Checkpoints written by
``save_state`` embed the serialized :class:`RuntimeConfig`, so a restore
from a mismatched runtime fails loudly instead of misreading buffers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.runtime.config import NetworkConfig, RuntimeConfig
from repro_torch.runtime.registry import register_runtime


def _plan_ledger(specs, plan, workers: int) -> Dict[str, int]:
    """One synchronous iteration's fleet-wide transfer accounting (fp32
    both ways: push compression waits for a later slice)."""
    from repro_torch.dist.collectives import bucket_bytes
    pull = sum(bucket_bytes(specs, b) for b in plan.forward)
    push = sum(bucket_bytes(specs, b) for b in plan.backward)
    return {"pull_bytes": pull * workers, "push_bytes": push * workers,
            "pull_wire_bytes": pull * workers,
            "push_wire_bytes": push * workers,
            "num_pulls": len(plan.forward) * workers,
            "num_pushes": len(plan.backward) * workers}


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class RuntimeAdapter:
    """Shared bookkeeping of every registered runtime."""

    def __init__(self, config: RuntimeConfig, arch: ArchConfig,
                 batch_fn: Callable[[int], Any], device: torch.device):
        self.config = config
        self.arch = arch
        self.device = device
        self._batch_fn = batch_fn
        self._data_idx = 0            # units of progress consumed
        self._eval_events: List[Any] = []
        self.shape = InputShape("runtime", config.seq, config.batch, "train")

    # -- protocol surface ------------------------------------------------

    @property
    def events(self) -> Sequence[Any]:
        return tuple(self._eval_events)

    def timeline(self) -> Optional[Any]:
        return None

    @property
    def ledger(self) -> Dict[str, Any]:
        return {"pull_bytes": 0, "push_bytes": 0,
                "pull_wire_bytes": 0, "push_wire_bytes": 0,
                "num_pulls": 0, "num_pushes": 0}

    @staticmethod
    def _check_eval(eval_fn, eval_every: int) -> None:
        if eval_fn is not None and eval_every < 1:
            raise ValueError(f"eval_fn needs eval_every >= 1, got "
                             f"{eval_every}")

    @staticmethod
    def _check_checkpoint(checkpoint_every: int,
                          checkpoint_path: Optional[str]) -> None:
        if checkpoint_every and checkpoint_path is None:
            raise ValueError("checkpoint_every needs a checkpoint_path")
        if checkpoint_path is not None and checkpoint_every < 1:
            raise ValueError(f"checkpoint_path needs checkpoint_every >= 1, "
                             f"got {checkpoint_every}")

    def _record_eval(self, eval_fn) -> None:
        from repro_torch.runtime.protocol import EvalEvent
        self._eval_events.append(
            EvalEvent(unit=self._data_idx, loss=float(eval_fn())))

    def fit(self, steps: int, *, log_every: int = 0,
            eval_fn: Optional[Callable[[], float]] = None,
            eval_every: int = 0, checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None) -> List[float]:
        """Run ``steps`` units of progress from the configured data,
        printing a one-line progress report every ``log_every`` units.
        With ``eval_fn`` (zero-arg, returns a scalar loss), evaluate every
        ``eval_every`` units and record an ``EvalEvent`` into ``events``.
        With ``checkpoint_every``/``checkpoint_path``, ``save_state`` runs
        at every ``checkpoint_every``-unit boundary."""
        self._check_eval(eval_fn, eval_every)
        self._check_checkpoint(checkpoint_every, checkpoint_path)
        losses = []
        for _ in range(steps):
            losses.append(self.step(self._batch_fn(self._data_idx)))
            if log_every and len(losses) % log_every == 0:
                print(f"step {self._data_idx:4d}  loss {losses[-1]:.4f}")
            if eval_fn is not None and self._data_idx % eval_every == 0:
                self._record_eval(eval_fn)
            if checkpoint_every and \
                    self._data_idx % checkpoint_every == 0:
                self.save_state(checkpoint_path)
        return losses

    def step(self, batch) -> float:
        raise NotImplementedError

    # -- checkpoint plumbing --------------------------------------------

    def _save_tree(self, path: str, t: Dict[str, Any]) -> None:
        t = dict(t)
        t["config"] = np.asarray(self.config.to_json(indent=None))
        t["data_idx"] = np.asarray(self._data_idx, np.int64)
        save_checkpoint(path, t, step=self._data_idx)

    def _load_tree(self, path: str,
                   template: Dict[str, Any]) -> Dict[str, Any]:
        # check the embedded config BEFORE interpreting any buffers
        with np.load(path) as probe:
            if "config" not in probe.files:
                raise ValueError(f"{path} is not a runtime checkpoint "
                                 f"(no embedded config)")
            saved = RuntimeConfig.from_json(str(probe["config"]))
        if saved.runtime != self.config.runtime:
            raise ValueError(
                f"checkpoint {path} was written by runtime "
                f"{saved.runtime!r}; this runtime is "
                f"{self.config.runtime!r} — rebuild from the checkpoint's "
                f"own config")
        template = dict(template)
        template["config"] = np.asarray("")
        template["data_idx"] = np.zeros((), np.int64)
        t, _ = load_checkpoint(path, template)
        self._data_idx = int(t["data_idx"])
        return t

    def _to_device(self, numpy_tree):
        return tree.tree_map(lambda x: torch.from_numpy(np.array(x)).to(
            self.device), numpy_tree)


@register_runtime("local", description="single-process training, no "
                                       "distribution layer")
class LocalRuntime(RuntimeAdapter):
    """Whole-model autograd training on one device (no collectives)."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.models import init_params
        from repro_torch.train.loop import build_train_step
        self.optimizer = config.build_optimizer()
        params = init_params(arch, _generator(device, config.seed),
                             torch.float32, device)
        self._params = tree.tree_map(lambda x: x.requires_grad_(), params)
        self._opt_state = self.optimizer.init(tree.leaves(self._params))
        self._step_fn = build_train_step(arch, self.optimizer,
                                         aux_weight=config.aux_weight)

    def step(self, batch) -> float:
        batch = {k: v.to(self.device) for k, v in batch.items()}
        self._params, self._opt_state, loss = self._step_fn(
            self._params, self._opt_state, batch)
        self._data_idx += 1
        return float(loss)

    def _checkpoint_tree(self) -> Dict[str, Any]:
        """Params and optimizer state, the moments shaped like the params
        (the reference's checkpoint layout)."""
        struct = tree.structure(self._params)
        opt = self._opt_state
        shaped = (lambda bufs: None if bufs is None
                  else tree.unflatten(struct, list(bufs)))
        return {"params": self._params,
                "opt": opt._replace(mu=shaped(opt.mu), nu=shaped(opt.nu))}

    def save_state(self, path: str) -> None:
        self._save_tree(path, self._checkpoint_tree())

    def restore_state(self, path: str) -> None:
        current = self._checkpoint_tree()
        t = self._load_tree(path, current)
        with torch.no_grad():
            for cur, new in zip(tree.leaves(current), tree.leaves(
                    {"params": t["params"], "opt": t["opt"]})):
                cur.copy_(torch.from_numpy(np.array(new)))


class _CompiledRuntime(RuntimeAdapter):
    """Base for the synchronous bucketed regimes: holds the training
    state and per-iteration transfer accounting."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        self._led = {"pull_bytes": 0, "push_bytes": 0,
                     "pull_wire_bytes": 0, "push_wire_bytes": 0,
                     "num_pulls": 0, "num_pushes": 0}
        self._led_by_plan: Dict[Any, Dict[str, int]] = {}

    def _account(self, specs, plan, workers: int) -> None:
        if plan not in self._led_by_plan:
            self._led_by_plan[plan] = _plan_ledger(specs, plan, workers)
        for k, v in self._led_by_plan[plan].items():
            self._led[k] += v

    @property
    def ledger(self) -> Dict[str, Any]:
        led = dict(self._led)
        led["push_compression_ratio"] = (
            led["push_bytes"] / led["push_wire_bytes"]
            if led["push_wire_bytes"] else 1.0)
        return led

    def save_state(self, path: str) -> None:
        """Rank 0 writes the whole (unsharded) state."""
        whole = self.trainer.global_state(self._state)
        if self.trainer.rank == 0:
            self._save_tree(path, {"model": whole})

    def restore_state(self, path: str) -> None:
        t = self._load_tree(
            path, {"model": self.trainer.global_state(self._state)})
        self._state = self.trainer.local_state(self._to_device(t["model"]))


@register_runtime("zero", description="DynaComm-bucketed ZeRO trainer, "
                                      "plan decided once at startup")
class ZeroRuntime(_CompiledRuntime):
    """Profile → schedule → bucketed ZeRO trainer (static plan)."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.core import (DynaCommScheduler, costs_from_profiles,
                                      plan_from_decision)
        from repro_torch.dist.zero import ZeroTrainer
        from repro_torch.models import num_sched_layers
        from repro_torch.models.profiles import layer_profiles
        net = (config.schedule.network or NetworkConfig()).build()
        self._costs = costs_from_profiles(
            layer_profiles(arch, self.shape), net=net,
            compute_flops_per_s=config.measure.compute_flops_per_s)
        self.scheduler = DynaCommScheduler(
            strategy=config.schedule.strategy,
            reschedule_every=config.schedule.reschedule_every)
        self._decision = self.scheduler.decision_for_iteration(self._costs)
        plan = plan_from_decision(*self._decision, num_sched_layers(arch))
        self.trainer = ZeroTrainer(
            cfg=arch, plan=plan, optimizer=config.build_optimizer(),
            device=device, zero3=config.execution.zero3,
            aux_weight=config.aux_weight)
        self._state = self.trainer.init_state(
            _generator(device, config.seed))

    @property
    def plan(self):
        return self.trainer.plan

    def step(self, batch) -> float:
        self._state, loss = self.trainer.step(self._state, batch)
        self._account(self.trainer.specs, self.trainer.plan,
                      self.trainer.axis_size)
        self._data_idx += 1
        return float(loss)

    def timeline(self):
        from repro_torch.core import simulate_iteration
        return simulate_iteration(self._costs, *self._decision)
