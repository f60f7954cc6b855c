"""Runtime adapters: the ported trainers behind one ``Trainer`` protocol.

Each adapter owns everything a regime needs to run — device, optimizer,
model/arch config, trainer, training state, transfer accounting — and
presents the uniform protocol surface (``fit`` / ``step`` / ``events`` /
``timeline`` / ``ledger`` / ``save_state`` / ``restore_state``).  The
underlying trainer stays reachable as ``.trainer``.

The port so far has ``local`` (whole-model autograd, no collectives),
``zero`` (the DynaComm-bucketed ZeRO step), ``ps`` (the synchronous
parameter-server step: the ZeRO step under a topology's consensus plan,
optionally with compressed pushes), their run-time re-planning loops
``dynamic`` and ``dynamic-ps`` (re-plan per epoch, swap the plan's step
live; each step is accounted against the plan active in it), and the
asynchronous ``ps-async`` and ``dynamic-ps-async`` (the bounded-staleness
event loop over a versioned server, per-worker re-plans per topology
epoch in the dynamic one), ``fleet-async`` (the same loop over an
elastic fleet: churn-driven re-plans, server re-sharding, drift and stall
detection), and ``pipeline`` (DP-balanced stages over micro-batches in one
process, DynaComm-planned boundary transfers).  Every runtime draws its initial weights from
the same seeded generator, so a dynamic run starts from the static run's
state.

Unit of progress: a *training step* for the synchronous regimes, an
*accepted gradient push* for the asynchronous ones — ``fit(n)`` returns
one loss per unit.  Checkpoints written by
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
from repro_torch.runtime.config import (FleetConfig, NetworkConfig,
                                        RuntimeConfig, TopologyConfig)
from repro_torch.runtime.registry import register_runtime

# per-worker data streams of the async regimes stay disjoint by striding
# the deterministic batch index (the reference's convention)
WORKER_STRIDE = 100003


def _plan_ledger(specs, plan, workers: int,
                 compressor: Optional[Any] = None) -> Dict[str, int]:
    """One synchronous iteration's fleet-wide transfer accounting.

    ``push_wire_bytes`` is what the uplink actually carries: compressed
    per-layer payloads plus the per-segment header when a ``compressor``
    is active, the fp32 payload otherwise (pulls always stay fp32)."""
    from repro_torch.dist.collectives import bucket_bytes
    pull = sum(bucket_bytes(specs, b) for b in plan.forward)
    push = sum(bucket_bytes(specs, b) for b in plan.backward)
    if compressor is None:
        push_wire = push
    else:
        push_wire = sum(
            int(round(sum(float(compressor.wire_bytes(specs[l].total * 4))
                          for l in b) + compressor.segment_overhead_bytes))
            for b in plan.backward)
    return {"pull_bytes": pull * workers, "push_bytes": push * workers,
            "pull_wire_bytes": pull * workers,
            "push_wire_bytes": push_wire * workers,
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
        from repro_torch.train.loop import opt_tree
        return {"params": self._params,
                "opt": opt_tree(self._opt_state, self._params)}

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

    def _account(self, specs, plan, workers: int,
                 compressor: Optional[Any] = None) -> None:
        if plan not in self._led_by_plan:
            self._led_by_plan[plan] = _plan_ledger(specs, plan, workers,
                                                   compressor)
        for k, v in self._led_by_plan[plan].items():
            self._led[k] += v

    @property
    def ledger(self) -> Dict[str, Any]:
        led = dict(self._led)
        led["push_compression_ratio"] = (
            led["push_bytes"] / led["push_wire_bytes"]
            if led["push_wire_bytes"] else 1.0)
        return led

    @property
    def _layout(self):
        """The trainer that owns the state layout (a dynamic trainer's
        ``base``, else the trainer itself)."""
        return getattr(self.trainer, "base", self.trainer)

    def save_state(self, path: str) -> None:
        """Rank 0 writes the whole (unsharded) state."""
        whole = self._layout.global_state(self._state)
        if self._layout.rank == 0:
            self._save_tree(path, {"model": whole})

    def restore_state(self, path: str) -> None:
        t = self._load_tree(
            path, {"model": self._layout.global_state(self._state)})
        self._state = self._layout.local_state(self._to_device(t["model"]))


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


class _ReplanRuntime(_CompiledRuntime):
    """Base for the run-time loops (a ``ReplanMixin`` trainer): its
    events, its active plan and its loop state beside the model's."""

    @property
    def events(self):
        return tuple(self.trainer.events) + tuple(self._eval_events)

    @property
    def plan(self):
        return self.trainer.plan

    def save_state(self, path: str) -> None:
        super().save_state(path)
        if self._layout.rank == 0:
            self.trainer.save_loop_state(path + ".loop")

    def restore_state(self, path: str) -> None:
        super().restore_state(path)
        self.trainer.restore_loop_state(path + ".loop")


@register_runtime("dynamic", description="run-time loop: re-profile + "
                                         "re-plan per epoch, swap the plan's "
                                         "step live")
class DynamicRuntime(_ReplanRuntime):
    """Epoch-boundary re-scheduling (paper Section IV-C) over ZeRO."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.dist.dynamic import DynamicTrainer
        detector = None
        if config.schedule.drift_detect:
            from repro_torch.core import EwmaDriftDetector
            detector = EwmaDriftDetector()
        net = (config.schedule.network or NetworkConfig()).build()
        self.trainer = DynamicTrainer(
            cfg=arch, optimizer=config.build_optimizer(), network=net,
            steps_per_epoch=config.schedule.reschedule_every, device=device,
            strategy=config.schedule.strategy, input_shape=self.shape,
            cost_source=config.measure.cost_source,
            compute_flops_per_s=config.measure.compute_flops_per_s,
            measure_iters=config.measure.measure_iters,
            measure_warmup=config.measure.measure_warmup,
            remeasure_every=config.measure.remeasure_every,
            drift_detector=detector, zero3=config.execution.zero3,
            aux_weight=config.aux_weight,
            async_planning=config.schedule.async_planning,
            plan_cache_size=config.schedule.plan_cache_size)
        self._state = self.trainer.init_state(
            _generator(device, config.seed))

    def step(self, batch) -> float:
        self._state, loss = self.trainer.step(self._state, batch)
        self._account(self.trainer.base.specs, self.trainer.plan,
                      self.trainer.base.axis_size)
        self._data_idx += 1
        return float(loss)

    def timeline(self):
        return self.trainer.timeline()


def _build_topology(config: RuntimeConfig, device: torch.device):
    """The configured PS topology; a topology that names no workers gets
    one per rank of the process group (made world-1 if none exists)."""
    import torch.distributed as dist
    from repro_torch.dist.zero import default_group
    topo_cfg = config.schedule.topology or TopologyConfig()
    return topo_cfg.build(default_workers=dist.get_world_size(
        default_group(device)))


@register_runtime("ps", description="synchronous parameter-server "
                                    "execution: consensus plan, one pull + "
                                    "one push per segment")
class PSRuntime(_CompiledRuntime):
    """Sync PS: segmented pull/push on the group (== ZeRO bitwise)."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.ps import PSTrainer
        self.trainer = PSTrainer.from_topology(
            arch, _build_topology(config, device), config.build_optimizer(),
            self.shape, device=device, strategy=config.schedule.strategy,
            compressor=config.compression.build(),
            zero3=config.execution.zero3, aux_weight=config.aux_weight)
        self._state = self.trainer.init_state(
            _generator(device, config.seed))

    @property
    def plan(self):
        return self.trainer.plan

    def step(self, batch) -> float:
        self._state, loss = self.trainer.step(self._state, batch)
        self._account(self.trainer.specs, self.trainer.plan,
                      self.trainer.topology.num_workers,
                      self.trainer.compressor)
        self._data_idx += 1
        return float(loss)

    def timeline(self):
        return self.trainer.timeline(self.shape)


@register_runtime("dynamic-ps", description="run-time loop in the PS "
                                            "regime: consensus re-plan per "
                                            "topology epoch")
class DynamicPSRuntime(_ReplanRuntime):
    """Topology-epoch re-planning over the sync PS trainer."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.ps import DynamicPSTrainer
        self.trainer = DynamicPSTrainer(
            cfg=arch, optimizer=config.build_optimizer(),
            topology=_build_topology(config, device),
            steps_per_epoch=config.schedule.reschedule_every,
            input_shape=self.shape, device=device,
            strategy=config.schedule.strategy,
            zero3=config.execution.zero3, aux_weight=config.aux_weight,
            compressor=config.compression.build(),
            cost_source=config.measure.cost_source,
            remeasure_every=config.measure.remeasure_every,
            measure_iters=config.measure.measure_iters,
            measure_warmup=config.measure.measure_warmup,
            async_planning=config.schedule.async_planning,
            plan_cache_size=config.schedule.plan_cache_size)
        self._state = self.trainer.init_state(
            _generator(device, config.seed))

    def step(self, batch) -> float:
        self._state, loss = self.trainer.step(self._state, batch)
        self._account(self.trainer.base.specs, self.trainer.plan,
                      self.trainer.base.topology.num_workers,
                      self.trainer.compressor)
        self._data_idx += 1
        return float(loss)

    def timeline(self):
        return None if self.trainer.plan is None else self.trainer.timeline()


class _AsyncBase(RuntimeAdapter):
    """Shared machinery of the asynchronous (event-loop) regimes.

    A unit of progress is one *accepted* gradient push.  ``fit`` drives
    the per-worker deterministic data streams; ``step(batch)`` feeds the
    given batch to every worker attempt until one more push commits.
    Under BSP aggregation a whole same-version group commits at once;
    ``step`` then returns the group's mean loss (the synchronous-step
    convention) and ``fit`` may return up to ``W - 1`` more losses than
    requested.

    The loss recomputes each block in the backward (``remat=True``): the
    same numbers as keeping the activations, and the memory the server's
    versions and the gradients in flight need at full width.
    """

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.models import params_from_sched_layers, train_loss
        aux = config.aux_weight

        def loss_fn(layer_list, batch):
            return train_loss(arch, params_from_sched_layers(layer_list),
                              batch, aux_weight=aux, remat=True)

        self._loss_fn = loss_fn
        self._started = False
        self._reported = 0           # accepted events already returned

    def _initial_layers(self) -> List[Any]:
        """The seeded initial weights as sched-layer trees (the trainer
        flattens them into the server; nothing here keeps them)."""
        from repro_torch.models import init_params, sched_layer_trees
        return sched_layer_trees(init_params(
            self.arch, _generator(self.device, self.config.seed),
            torch.float32, self.device))

    # each concrete class provides: _run_pushes(n, wfn) -> AsyncRunLog,
    # and a `_server` property
    def _run_pushes(self, num_pushes, worker_batch_fn):
        raise NotImplementedError

    @property
    def _server(self):
        raise NotImplementedError

    def _worker_batch_fn(self):
        fn = self._batch_fn
        return lambda w, i: fn(w * WORKER_STRIDE + i)

    def _drive(self, pushes: int, wfn) -> List[float]:
        log = self._run_pushes(pushes, wfn)
        self._started = True
        fresh = log.accepted[self._reported:]
        self._reported = len(log.accepted)
        self._data_idx += len(fresh)
        return [e.loss for e in fresh]

    def fit(self, steps: int, *, log_every: int = 0,
            eval_fn: Optional[Callable[[], float]] = None,
            eval_every: int = 0, checkpoint_every: int = 0,
            checkpoint_path: Optional[str] = None) -> List[float]:
        # accepted pushes land in chunks (BSP aggregation can commit a
        # whole cohort), so evals and checkpoints trigger on *boundary
        # crossings* of the cumulative push count rather than exact
        # multiples
        self._check_eval(eval_fn, eval_every)
        self._check_checkpoint(checkpoint_every, checkpoint_path)
        losses: List[float] = []
        wfn = self._worker_batch_fn()
        while len(losses) < steps:
            chunk = min(log_every or steps, steps - len(losses))
            if eval_fn is not None:
                chunk = min(chunk, eval_every - self._data_idx % eval_every)
            if checkpoint_every:
                chunk = min(chunk, checkpoint_every -
                            self._data_idx % checkpoint_every)
            before = self._data_idx
            losses.extend(self._drive(chunk, wfn))
            if log_every:
                print(f"push {self._data_idx:4d}  loss {losses[-1]:.4f}")
            if eval_fn is not None and \
                    self._data_idx // eval_every > before // eval_every:
                self._record_eval(eval_fn)
            if checkpoint_every and self._data_idx // checkpoint_every > \
                    before // checkpoint_every:
                self.save_state(checkpoint_path)
        return losses

    def step(self, batch) -> float:
        fresh = self._drive(1, lambda w, i: batch)
        return float(np.mean(fresh))

    @property
    def ledger(self) -> Dict[str, Any]:
        led = self._server.ledger
        return {"pull_bytes": sum(led.pulled_bytes.values()),
                "push_bytes": sum(led.pushed_bytes.values()),
                "pull_wire_bytes": sum(led.pulled_wire_bytes.values()),
                "push_wire_bytes": sum(led.pushed_wire_bytes.values()),
                "push_compression_ratio": led.compression_ratio("push"),
                "num_pulls": led.num_pulls,
                "num_pushes": led.num_pushes,
                "rejected_pushes": led.rejected_pushes,
                "waited_pushes": led.waited_pushes}

    def save_state(self, path: str) -> None:
        """Checkpoint the server's head parameters + optimizer state.

        Event-loop state (in-flight computations) is not serialized; the
        restore discards the loop, so training resumes from the restored
        parameters at simulated time 0."""
        self._save_tree(path, {"server": self._server.state_dict()})

    def restore_state(self, path: str) -> None:
        t = self._load_tree(path, {"server": self._server.state_template()})
        self._server.load_state_dict(t["server"])
        # in-flight gradients were computed against pre-restore weights
        # and pinned at pre-restore versions: committing them against the
        # rolled-back server would corrupt the trajectory
        self.trainer.reset_loop()
        self._started = False
        self._reported = 0


@register_runtime("ps-async", description="bounded-staleness asynchronous "
                                          "PS: reject or SSP-wait "
                                          "throttle, optional BSP "
                                          "aggregation")
class PSAsyncRuntime(_AsyncBase):
    """Event-driven bounded-staleness execution over a static topology."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.core import plan_from_decision
        from repro_torch.core.scheduler import consensus_decision
        from repro_torch.models import num_sched_layers
        from repro_torch.models.profiles import layer_profiles
        from repro_torch.ps import AsyncPSTrainer
        topo = _build_topology(config, device)
        comp = config.compression.build()
        costs = topo.topology_costs(layer_profiles(arch, self.shape),
                                    compressor=comp)
        decision, self.sync_makespan = consensus_decision(
            costs, config.schedule.strategy)
        plan = plan_from_decision(*decision, num_sched_layers(arch))
        self.trainer = AsyncPSTrainer(
            init_layers=self._initial_layers(), loss_fn=self._loss_fn,
            optimizer=config.build_optimizer(), topology=topo, plan=plan,
            staleness=config.execution.staleness or 0,
            throttle=config.execution.throttle,
            aggregate=config.execution.aggregate, costs=costs,
            compressor=comp)

    @property
    def _server(self):
        return self.trainer.server

    def _run_pushes(self, num_pushes, wfn):
        return self.trainer.run(num_pushes, wfn, reset=not self._started)

    def timeline(self):
        return self.trainer.log


@register_runtime("dynamic-ps-async",
                  description="per-worker re-planning per topology epoch "
                              "over the bounded-staleness event loop")
class DynamicPSAsyncRuntime(_AsyncBase):
    """Per-worker re-plans swapped into the async loop on epoch bounds."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.models.profiles import layer_profiles
        from repro_torch.ps import DynamicAsyncPSTrainer
        self.trainer = DynamicAsyncPSTrainer(
            init_layers=self._initial_layers(), loss_fn=self._loss_fn,
            optimizer=config.build_optimizer(),
            topology=_build_topology(config, device),
            pushes_per_epoch=config.schedule.reschedule_every,
            staleness=config.execution.staleness or 0,
            throttle=config.execution.throttle,
            aggregate=config.execution.aggregate,
            strategy=config.schedule.strategy,
            profiles=layer_profiles(arch, self.shape),
            compressor=config.compression.build(),
            async_planning=config.schedule.async_planning,
            plan_cache_size=config.schedule.plan_cache_size)

    @property
    def events(self):
        return tuple(self.trainer.events) + tuple(self._eval_events)

    @property
    def _server(self):
        return self.trainer.trainer.server

    def _run_pushes(self, num_pushes, wfn):
        return self.trainer.run_pushes(num_pushes, wfn)

    def timeline(self):
        return self.trainer.trainer.log


@register_runtime("fleet-async",
                  description="elastic worker fleet on the deterministic "
                              "event engine: churn-driven re-planning, "
                              "server re-sharding, measured drift "
                              "detection")
class FleetRuntime(_AsyncBase):
    """Elastic membership over the bounded-staleness event loop.

    The initial fleet comes from the topology block (one
    :class:`~repro_torch.fleet.WorkerSpec` per configured link); the fleet
    block scripts or synthesizes membership churn and tunes the stall
    and drift detectors.  Unlike the other async adapters, ``save_state``
    also serializes the *event-loop* state (in-flight work, admission
    queue, simulated clock), so a restored run resumes mid-simulation
    bit-identically instead of restarting the loop at time 0."""

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.fleet import FleetTrainer, WorkerSpec
        from repro_torch.models.profiles import layer_profiles
        topo = _build_topology(config, device)
        specs = {w: WorkerSpec(down_bps=link.down.bandwidth_bps,
                               up_bps=link.up.bandwidth_bps,
                               flops=topo.worker_flops[w])
                 for w, link in enumerate(topo.links)}
        fleet_cfg = config.fleet or FleetConfig()
        self.trainer = FleetTrainer(
            init_layers=self._initial_layers(), loss_fn=self._loss_fn,
            optimizer=config.build_optimizer(), workers=specs,
            schedule=fleet_cfg.build_schedule(tuple(specs)),
            num_servers=topo.num_servers,
            workers_per_shard=fleet_cfg.workers_per_shard,
            staleness=config.execution.staleness or 0,
            throttle=config.execution.throttle,
            strategy=config.schedule.strategy,
            profiles=layer_profiles(arch, self.shape),
            compressor=config.compression.build(),
            drift_detector=fleet_cfg.build_detector(),
            stall_factor=fleet_cfg.stall_factor,
            check_interval=fleet_cfg.check_interval,
            async_planning=config.schedule.async_planning,
            plan_cache_size=config.schedule.plan_cache_size)

    @property
    def events(self):
        timed = sorted(tuple(self.trainer.replan_events) +
                       tuple(self.trainer.membership_events),
                       key=lambda e: e.sim_time)
        return tuple(timed) + tuple(self._eval_events)

    @property
    def _server(self):
        return self.trainer.server

    def _run_pushes(self, num_pushes, wfn):
        return self.trainer.run(num_pushes, wfn, reset=not self._started)

    def timeline(self):
        return self.trainer.log

    def save_state(self, path: str) -> None:
        """Checkpoint server state plus the live event loop.

        The loop (engine queue, in-flight gradients, SSP barrier,
        membership roster, detector streams, run log) lands next to the
        parameter checkpoint at ``path + ".loop"``."""
        self._save_tree(path, {"server": self.trainer.server.state_dict()})
        self.trainer.save_loop_state(path + ".loop")

    def restore_state(self, path: str) -> None:
        t = self._load_tree(path,
                            {"server": self.trainer.server.state_template()})
        self.trainer.server.load_state_dict(t["server"])
        self.trainer.restore_loop_state(path + ".loop")
        # the loop resumes mid-simulation: keep driving the restored run
        # instead of resetting to time 0
        self._started = True
        log = self.trainer.log
        self._reported = len(log.accepted) if log is not None else 0


@register_runtime("pipeline",
                  description="stage-partitioned pipeline parallelism with "
                              "DynaComm-scheduled activation transfers")
class PipelineRuntime(_CompiledRuntime):
    """Profile → DP stage partition → micro-batch pipeline execution.

    Stages are balanced by profiled fc + bc via
    :func:`repro_torch.pipeline.partition_profiles`; inter-stage activation
    traffic is planned through the shared edge cost model
    (``dp_forward``/``dp_backward`` over virtual boundary layers) riding a
    :class:`~repro_torch.core.planner.Planner`, so homogeneous boundaries
    are one DP solve plus cache hits.  Every stage runs in this process on
    the runtime's device; no process group is made.
    """

    def __init__(self, config, arch, batch_fn, device):
        super().__init__(config, arch, batch_fn, device)
        from repro_torch.core import costs_from_profiles
        from repro_torch.core.planner import Planner
        from repro_torch.models.profiles import layer_profiles
        from repro_torch.pipeline import PipelineTrainer, partition_profiles
        pcfg = config.pipeline        # materialized by RuntimeConfig
        net = (config.schedule.network or NetworkConfig()).build()
        profiles = layer_profiles(arch, self.shape)
        partition = partition_profiles(
            profiles, pcfg.stages,
            compute_flops_per_s=config.measure.compute_flops_per_s)
        self._costs = costs_from_profiles(
            profiles, net=net,
            compute_flops_per_s=config.measure.compute_flops_per_s)
        self.planner = Planner(cache_size=config.schedule.plan_cache_size)
        self.trainer = PipelineTrainer(
            cfg=arch, optimizer=config.build_optimizer(), device=device,
            num_stages=pcfg.stages, num_microbatches=pcfg.microbatches,
            schedule_name=pcfg.schedule, aux_weight=config.aux_weight,
            partition=partition, planner=self.planner,
            transfer_strategy=config.schedule.strategy,
            costs=self._costs, net=net, transfer_chunks=pcfg.chunks)
        self._state = self.trainer.init_state(
            _generator(device, config.seed))

    @property
    def partition(self):
        return self.trainer.partition

    def step(self, batch) -> float:
        self._state, loss = self.trainer.step(self._state, batch)
        self._data_idx += 1
        return float(loss)

    @property
    def ledger(self) -> Dict[str, Any]:
        led = dict(self.trainer.ledger)
        led["push_compression_ratio"] = 1.0   # activations stay fp32
        return led

    def timeline(self):
        return self.trainer.timeline()
