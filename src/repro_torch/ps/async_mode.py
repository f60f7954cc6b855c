"""Bounded-staleness asynchronous PS execution.

Synchronous mode (``repro_torch.ps.worker.PSTrainer``) pays the straggler
at every barrier; this module removes the barrier: each worker pulls a
parameter snapshot, computes gradients *against that version*, and pushes
— every *applied* gradient's staleness (head version at commit minus the
version it was computed at) is bounded by ``k``.  Two throttle
disciplines enforce the bound:

* ``throttle="reject"`` — the server-side gate: a push staler than ``k``
  at commit time is evicted and the worker re-pulls the head and
  recomputes.  Simple, but fast workers advance the head while a slow
  worker computes, so a worker ~W× slower than the rest can be rejected
  *every* time at small ``k`` — it never contributes.
* ``throttle="wait"`` — Stale Synchronous Parallel wait-at-barrier
  semantics: nobody's gradients are ever dropped; instead the *fast*
  side blocks.  Two gates in the discrete-event loop:

  1. **admission** — a worker may start a new pull+compute only while at
     most ``k`` other computations are in flight (uncommitted), because
     under global versioning every in-flight computation is a future head
     increment: admitting a (k+2)-th concurrent computation would force
     some commit beyond the bound;
  2. **commit barrier** — a completed computation commits only once its
     pinned version is the *minimum* over all in-flight computations;
     fresher completions wait at the barrier until the laggard commits
     (ties drain in completion order, then worker id).

  Together these guarantee every push is accepted with staleness <= k and
  every worker — however slow — eventually contributes; ``k=0``
  degenerates to fully-serialized sequential SGD, exactly as in reject
  mode, but with waiting instead of wasted recomputation.

Execution is a deterministic discrete-event simulation driven by the
topology's per-worker costs: each worker's pull → compute → push latency
comes from its own ``LayerCosts`` under its ``BucketPlan`` (via
``core.simulator``), the :class:`repro_torch.fleet.engine.EventQueue`
orders completions by ``(simulated time, insertion seq, worker id)``, and
gradient math runs for real through one autograd function shared by all
workers (:func:`value_and_grad`, the counterpart of the reference's jitted
``jax.value_and_grad``) — so the event sequence is a pure function of the
costs, equal to the reference's event for event, while losses come from
actually training the model.

A worker's gradients wait in the event queue as one flat buffer per
layer, flattened one layer at a time as autograd hands them back (the
payload costs one copy of the parameters) and handed to the server layer
by layer as the push goes out.

Plans may differ per worker (the asynchronous planning mode of
``core.scheduler.schedule_topology``): pass a sequence of ``BucketPlan``s,
one per worker, instead of a single shared plan.  ``set_plans`` swaps
plans between (not during) event-loop runs — the ``repro_torch.ps.dynamic``
trainer uses this on topology-epoch boundaries.

The trainer is generic over "a model whose parameters are a list of
per-layer trees + a loss function": the small CNN
(``repro_torch.models.cnn``) and the text archs (``sched_layer_trees`` +
``train_loss``) both fit.  It runs on the device of the initial layers;
batches are moved there.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch import tree
from repro_torch.core.buckets import BucketPlan, decision_from_plan
from repro_torch.core.costmodel import TopologyCosts, iteration_time
from repro_torch.dist.collectives import (FlatSpec, flatten_tree,
                                          make_flat_spec, unflatten_tree)
from repro_torch.fleet.engine import EventQueue
from repro_torch.optim import Optimizer
from repro_torch.ps.server import PSServer, PushResult, StaleVersion
from repro_torch.ps.topology import PSTopology

THROTTLES = ("reject", "wait")


def value_and_grad(loss_fn: Callable[[List[Any], Dict[str, Any]], Any]
                   ) -> Callable[[Sequence[Any], Dict[str, Any]],
                                 Tuple[float, List[Any]]]:
    """``fn(layers, batch) -> (float loss, per-layer gradient trees)``.

    The layers' leaves are detached (they may be views of server buffers),
    marked ``requires_grad`` and differentiated with one
    ``torch.autograd.grad`` over the whole loss; a leaf the loss does not
    use gets a zero gradient, as under ``jax.value_and_grad``."""
    def grad_fn(layers, batch):
        params = [tree.tree_map(lambda x: x.detach().requires_grad_(), t)
                  for t in layers]
        leaves = [leaf for p in params for leaf in tree.leaves(p)]
        with torch.enable_grad():
            loss = loss_fn(params, batch)
        flat = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True))
        grads, i = [], 0
        for p in params:
            n = len(tree.leaves(p))
            grads.append(tree.unflatten(tree.structure(p), flat[i:i + n]))
            i += n
        return float(loss.detach()), grads

    return grad_fn


@dataclasses.dataclass(frozen=True)
class AsyncPushEvent:
    """One committed (accepted or rejected) push, in commit order."""

    worker: int
    sim_time: float           # simulated seconds at commit
    version: int              # version the gradients were computed at
    result: PushResult
    loss: float
    retries: int              # stale rejections before this commit
    wait_s: float = 0.0       # wait throttle: seconds blocked at the barrier


@dataclasses.dataclass
class AsyncRunLog:
    events: List[AsyncPushEvent] = dataclasses.field(default_factory=list)

    @property
    def accepted(self) -> List[AsyncPushEvent]:
        return [e for e in self.events if e.result.accepted]

    @property
    def losses(self) -> List[float]:
        return [e.loss for e in self.accepted]

    @property
    def max_staleness(self) -> int:
        return max((e.result.staleness for e in self.accepted), default=0)

    @property
    def num_rejected(self) -> int:
        return sum(1 for e in self.events if not e.result.accepted)

    @property
    def makespan(self) -> float:
        return max((e.sim_time for e in self.events), default=0.0)

    @property
    def total_wait_s(self) -> float:
        """Simulated seconds spent blocked at the SSP barrier (0 under the
        reject throttle)."""
        return sum(e.wait_s for e in self.events)

    def accepted_by_worker(self) -> Dict[int, int]:
        """{worker: number of accepted pushes} (workers with none absent)."""
        out: Dict[int, int] = {}
        for e in self.accepted:
            out[e.worker] = out.get(e.worker, 0) + 1
        return out


class AsyncPSTrainer:
    """Event-driven bounded-staleness trainer over a PS topology.

    Parameters
    ----------
    init_layers:
        per-layer parameter trees (the model's sched-layer view), on the
        device the trainer runs on; flattened into the server's buffers.
    loss_fn:
        ``loss_fn(layers, batch) -> scalar`` over the *assembled* layer
        list; differentiated by :func:`value_and_grad` and shared by
        every worker.
    plan:
        the shared ``BucketPlan`` — each forward bucket is one pull
        message, each backward bucket one push message — or one plan per
        worker (the per-worker asynchronous planning mode).
    staleness:
        the bound ``k``: an applied push computed at version ``v``
        satisfies ``head − v ≤ k`` at commit.
    throttle:
        ``"reject"`` (server evicts stale pushes, workers recompute) or
        ``"wait"`` (SSP wait-at-barrier: fast workers block, nothing is
        dropped — see the module docstring).
    aggregate:
        wait throttle only: commit all same-version pushes as ONE
        mean-gradient optimizer step once the version group completes —
        k=0 becomes true bulk-synchronous data parallelism (one version
        bump per round of W pushes) instead of serialized commits.
    costs:
        optional per-worker ``TopologyCosts`` driving the simulated
        clock; without it every worker's iteration costs one unit, which
        keeps the event order deterministic but uninformative.
    compressor:
        optional ``repro_torch.compress`` scheme applied to every gradient
        push (per-layer flat buffers round-tripped before they reach the
        server; pulls stay fp32).  With ``compressor.error_feedback`` each
        (worker, layer) pair carries a residual of its own compression
        error into its next push.  The ledger accounts wire vs logical
        bytes per worker.
    """

    def __init__(self, *, init_layers: Sequence[Any],
                 loss_fn: Callable[[List[Any], Dict[str, Any]], Any],
                 optimizer: Optimizer, topology: PSTopology,
                 plan: Union[BucketPlan, Sequence[BucketPlan]],
                 staleness: int = 1, throttle: str = "reject",
                 aggregate: bool = False,
                 costs: Optional[TopologyCosts] = None,
                 compressor=None):
        init_layers = list(init_layers)
        if not init_layers:
            raise ValueError("need at least one layer tree")
        if throttle not in THROTTLES:
            raise ValueError(f"throttle must be one of {THROTTLES}, got "
                             f"{throttle!r}")
        if aggregate and throttle != "wait":
            raise ValueError(
                "aggregate=True commits same-version pushes as one "
                "optimizer step at the SSP barrier; it requires "
                f"throttle='wait' (got {throttle!r})")
        if aggregate and staleness != 0:
            raise ValueError(
                f"aggregate=True admits workers in full-fleet cohorts, so "
                f"every commit has staleness 0 and k={staleness} would be "
                f"inert — pass staleness=0 (true BSP), or drop aggregation "
                f"for bounded-staleness overlap")
        self.topology = topology
        self.staleness = staleness
        self.throttle = throttle
        self.aggregate = aggregate
        self.specs: Tuple[FlatSpec, ...] = tuple(
            make_flat_spec(t, 1) for t in init_layers)
        self._plans = self._as_worker_plans(plan)
        flats = []
        with torch.no_grad():
            for l, spec in enumerate(self.specs):
                flats.append(flatten_tree(init_layers[l], spec))
                init_layers[l] = None     # one copy of the weights at a time
        self.device = flats[0].device
        if compressor is not None and compressor.scheme == "none":
            compressor = None
        self.compressor = compressor
        self.server = PSServer(self.specs, topology, optimizer, flats,
                               staleness_bound=staleness,
                               compressor=compressor)
        self._residuals: Dict[Tuple[int, int], torch.Tensor] = {}
        self._grad_fn = value_and_grad(loss_fn)
        if costs is not None and costs.num_workers != topology.num_workers:
            raise ValueError(f"costs for {costs.num_workers} workers, "
                             f"topology has {topology.num_workers}")
        self._costs = costs
        self._durations = self._iteration_durations()
        self._loop: Optional[_LoopState] = None

    # ------------------------------------------------------------------
    # plans (shared or per-worker, swappable between runs)
    # ------------------------------------------------------------------

    @property
    def plan(self) -> BucketPlan:
        """The shared plan; raises if workers run distinct plans."""
        distinct = set(self._plans)
        if len(distinct) != 1:
            raise ValueError("workers run per-worker plans; use plans")
        return self._plans[0]

    @property
    def plans(self) -> Tuple[BucketPlan, ...]:
        """One plan per worker (identical entries under a shared plan)."""
        return self._plans

    def _as_worker_plans(self, plan) -> Tuple[BucketPlan, ...]:
        W = self.topology.num_workers
        if isinstance(plan, BucketPlan):
            worker_plans = (plan,) * W
        else:
            worker_plans = tuple(plan)
            if len(worker_plans) != W:
                raise ValueError(f"{len(worker_plans)} plans for {W} "
                                 f"workers")
        L = len(self.specs)
        for p in dict.fromkeys(worker_plans):
            for direction in ("forward", "backward"):
                covered = sorted(l for b in getattr(p, direction) for l in b)
                if covered != list(range(L)):
                    raise ValueError(f"plan's {direction} buckets cover "
                                     f"layers {covered}, model has "
                                     f"0..{L - 1}")
        return worker_plans

    def set_plans(self, plan: Union[BucketPlan, Sequence[BucketPlan]],
                  costs: Optional[TopologyCosts] = None,
                  topology: Optional[PSTopology] = None) -> None:
        """Swap the active plan(s) — and optionally the simulated-clock
        costs and the topology itself — between event-loop runs (a
        topology-epoch boundary).  In-flight computations keep the
        durations they started with; new admissions use the new plans.
        A new ``topology`` is forwarded to the server (shard routing,
        ledger); its worker count must not change."""
        if topology is not None:
            if topology.num_workers != self.topology.num_workers:
                raise ValueError(
                    f"new topology has {topology.num_workers} workers, "
                    f"trainer was built with {self.topology.num_workers} — "
                    f"workers cannot join or leave mid-run")
            self.topology = topology
            self.server.topology = topology
        self._plans = self._as_worker_plans(plan)
        if costs is not None:
            if costs.num_workers != self.topology.num_workers:
                raise ValueError(f"costs for {costs.num_workers} workers, "
                                 f"topology has {self.topology.num_workers}")
            self._costs = costs
        self._durations = self._iteration_durations()

    def _iteration_durations(self) -> Tuple[float, ...]:
        if self._costs is None:
            # compute-bound default: duration ∝ 1 / worker compute rate,
            # normalized so the fastest worker's iteration is one unit
            flops = self.topology.worker_flops
            fastest = max(flops)
            return tuple(fastest / f for f in flops)
        return tuple(
            iteration_time(c, *decision_from_plan(p))
            for c, p in zip(self._costs.workers, self._plans))

    # ------------------------------------------------------------------
    # one worker attempt: segmented pull → grads → segmented push
    # ------------------------------------------------------------------

    def _pull_layers(self, worker: int) -> Tuple[int, List[Any]]:
        """Pull every forward segment at one pinned version."""
        while True:
            version: Optional[int] = None
            buffers: Dict[int, Any] = {}
            try:
                for bucket in self._plans[worker].forward:
                    v, flats = self.server.pull_bucket(
                        bucket, version=version, worker=worker)
                    version = v
                    buffers.update(flats)
            except StaleVersion:
                continue          # snapshot evicted mid-pull: restart at head
            layers = [unflatten_tree(buffers[l], self.specs[l])
                      for l in range(len(self.specs))]
            return version, layers

    def _compute(self, worker: int,
                 batch) -> Tuple[float, int, List[Optional[torch.Tensor]]]:
        """Pull (pinning a version) and compute gradients against it, as
        one flat buffer per layer."""
        version, layers = self._pull_layers(worker)
        batch = {k: v.to(self.device) for k, v in batch.items()}
        loss, grads = self._grad_fn(layers, batch)
        del layers
        flats: List[Optional[torch.Tensor]] = []
        for l, spec in enumerate(self.specs):
            flats.append(flatten_tree(grads[l], spec))
            grads[l] = None       # keep one copy of the gradients, not two
        return loss, version, flats

    def _compress_flat(self, worker: int, layer: int,
                       flat: torch.Tensor) -> torch.Tensor:
        """What the server reconstructs from this worker's wire payload;
        under error feedback the residual carries into the next push (the
        round trip works in place on ``flat``, which the caller gives
        up)."""
        if self.compressor is None:
            return flat
        if not self.compressor.error_feedback:
            return self.compressor.roundtrip(flat)
        key = (worker, layer)
        residual = self._residuals.get(key)
        if residual is None:
            residual = torch.zeros_like(flat)
        compressed, self._residuals[key] = \
            self.compressor.feedback_roundtrip(flat, residual)
        return compressed

    def _take(self, worker: int, layer: int,
              grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """Layer ``layer``'s pushed gradient, handed over out of the
        payload (whose slot empties, so the server's pending set holds the
        only copy)."""
        flat, grads[layer] = grads[layer], None
        return self._compress_flat(worker, layer, flat)

    def _push(self, worker: int, version: int,
              grads: List[Optional[torch.Tensor]]) -> PushResult:
        """Push every backward segment; the last one commits."""
        result: Optional[PushResult] = None
        for bucket in self._plans[worker].backward:
            flat_grads = {l: self._take(worker, l, grads) for l in bucket}
            result = self.server.push_bucket(worker, version, bucket,
                                             flat_grads)
            del flat_grads
        assert result is not None, "plan.backward committed no push"
        return result

    # ------------------------------------------------------------------
    # the event loop
    # ------------------------------------------------------------------

    def run(self, num_pushes: int,
            batch_fn: Callable[[int, int], Any], *,
            reset: bool = True) -> AsyncRunLog:
        """Run until ``num_pushes`` gradient pushes were *accepted*.

        Each worker pulls + computes at the *start* of its iteration and
        commits its push one per-worker iteration duration later — other
        workers' commits land in between, which is where staleness comes
        from.  ``batch_fn(worker, attempt_idx) -> batch`` supplies data;
        the attempt index increments per computation (including retries
        after a stale rejection), so every attempt sees fresh data.

        ``reset=False`` continues a previous run's event loop (simulated
        clock, in-flight computations, and attempt counters carry over;
        the returned log is cumulative) — the dynamic-PS trainer runs one
        topology epoch per call this way."""
        if num_pushes < 1:
            raise ValueError(f"num_pushes must be >= 1, got {num_pushes}")
        if reset or self._loop is None:
            self._loop = _LoopState(log=AsyncRunLog(),
                                    parked=list(range(
                                        self.topology.num_workers)))
        loop = self._loop
        target = loop.accepted + num_pushes
        if self.throttle == "wait" and self.aggregate:
            self._run_wait_agg(loop, target, batch_fn)
        elif self.throttle == "wait":
            self._run_wait(loop, target, batch_fn)
        else:
            self._run_reject(loop, target, batch_fn)
        return loop.log

    @property
    def computations(self) -> int:
        """Gradient computations started in the current loop (accepted,
        rejected and still in flight)."""
        return 0 if self._loop is None else sum(self._loop.attempts.values())

    # -- shared helpers -------------------------------------------------

    def _start(self, loop: "_LoopState", worker: int, now: float,
               batch_fn) -> None:
        """Admit ``worker``: pull at the head, compute, schedule commit."""
        loss, version, grads = self._compute(
            worker, batch_fn(worker, loop.attempts[worker]))
        loop.attempts[worker] += 1
        loop.queue.push(now + self._durations[worker], worker,
                        (version, loss, grads))

    # -- reject throttle -----------------------------------------------

    def _run_reject(self, loop: "_LoopState", target: int,
                    batch_fn) -> None:
        """Server-side eviction: every worker is always in flight; a push
        staler than k is rejected at commit and the worker recomputes."""
        while loop.parked:                      # admission is unconditional
            self._start(loop, loop.parked.pop(0), loop.now, batch_fn)
        while loop.accepted < target:
            ev = loop.queue.pop()
            t, w = ev.time, ev.worker
            version, loss, grads = ev.payload
            del ev
            loop.now = t
            result = self._push(w, version, grads)
            loop.log.events.append(AsyncPushEvent(
                worker=w, sim_time=t, version=version, result=result,
                loss=loss, retries=loop.retries[w]))
            loop.accepted += int(result.accepted)
            loop.retries[w] = loop.retries[w] + 1 if not result.accepted \
                else 0
            self._start(loop, w, t, batch_fn)

    # -- wait throttle (SSP wait-at-barrier) ----------------------------

    def _run_wait(self, loop: "_LoopState", target: int, batch_fn) -> None:
        """SSP semantics: admission gate + min-version commit barrier (see
        the module docstring).  Every push commits; nothing is dropped."""
        k = self.staleness

        def in_flight() -> int:
            return len(loop.queue) + len(loop.barrier)

        def admit(now: float) -> None:
            while loop.parked and in_flight() <= k:
                self._start(loop, loop.parked.pop(0), now, batch_fn)

        def min_pin() -> int:
            return min([e.payload[0] for e in loop.queue] +
                       [v for v, _, _, _, _ in loop.barrier])

        def drain(now: float) -> None:
            """Commit every barrier entry whose pin is the in-flight
            minimum, in (pin, completion, worker) order."""
            while loop.barrier and loop.accepted < target:
                loop.barrier.sort(key=lambda e: e[:3])
                pin, done_t, w, loss, grads = loop.barrier[0]
                if pin > min_pin():
                    return                     # blocked on a laggard
                loop.barrier.pop(0)
                assert self.server.head_distance(pin) <= k, \
                    "SSP gates must keep every commit within the bound"
                result = self._push(w, pin, grads)
                assert result.accepted, \
                    "a wait-throttled push can never be stale at commit"
                wait_s = now - done_t
                if wait_s > 0:
                    self.server.ledger.waited_pushes += 1
                loop.log.events.append(AsyncPushEvent(
                    worker=w, sim_time=now, version=pin, result=result,
                    loss=loss, retries=0, wait_s=wait_s))
                loop.accepted += 1
                loop.parked.append(w)          # wants its next iteration
                admit(now)                     # a slot just freed up

        # a resumed run may hold entries that became eligible exactly when
        # the previous run hit its push target: commit them at the clock
        # they were eligible, before waiting on any new completion
        drain(loop.now)
        admit(loop.now)
        while loop.accepted < target:
            ev = loop.queue.pop()
            t, w = ev.time, ev.worker
            version, loss, grads = ev.payload
            del ev
            loop.now = t
            loop.barrier.append((version, t, w, loss, grads))
            del grads
            drain(t)

    # -- wait throttle with BSP push aggregation ------------------------

    def _push_aggregate(self, group) -> List[PushResult]:
        """Ledger-account each group member's segmented push and commit
        the whole group as one aggregated (mean-gradient) optimizer step
        via :meth:`PSServer.push_aggregated`."""
        pushes = []
        for pin, _done_t, w, _loss, grads in group:
            full: Dict[int, Any] = {}
            for bucket in self._plans[w].backward:
                for l in bucket:
                    full[l] = self._take(w, l, grads)
                self.server.ledger.record_push(
                    w, self.server.segment_bytes(bucket),
                    wire_bytes=self.server.push_wire_bytes(bucket))
            pushes.append((w, pin, full))
        return self.server.push_aggregated(pushes)

    def _run_wait_agg(self, loop: "_LoopState", target: int,
                      batch_fn) -> None:
        """SSP wait with same-version aggregation: a *version group* (all
        completions pinned at the in-flight minimum version) commits as
        ONE mean-gradient optimizer step once its last member completes.

        With every worker admitted at the same head this is exactly
        bulk-synchronous data parallelism — at k=0 the serialized commits
        of plain ``wait`` become true BSP rounds, and staleness at commit
        is 0 for every member.  Groups are atomic: a run may overshoot its
        push target by up to ``W - 1`` accepted pushes when the target
        lands mid-group.
        """
        def admit(now: float) -> None:
            # safety gate mirroring SSP admission; under group-atomic
            # commits every in-flight pin >= head, so this never starves
            while loop.parked:
                pins = [e.payload[0] for e in loop.queue] + \
                       [e[0] for e in loop.barrier]
                floor = min(pins) if pins else self.server.version
                if self.server.version - floor > self.staleness:
                    return
                self._start(loop, loop.parked.pop(0), now, batch_fn)

        def drain(now: float) -> None:
            while loop.barrier and loop.accepted < target:
                loop.barrier.sort(key=lambda e: e[:3])
                pin = loop.barrier[0][0]
                if any(e.payload[0] <= pin for e in loop.queue):
                    return          # the version group is still computing
                group = [e for e in loop.barrier if e[0] == pin]
                del loop.barrier[:len(group)]    # sorted ⇒ group is prefix
                results = self._push_aggregate(group)
                for (v, done_t, w, loss, _grads), res in zip(group,
                                                             results):
                    assert res.accepted, \
                        "a whole-group commit can never be stale"
                    wait_s = now - done_t
                    if wait_s > 0:
                        self.server.ledger.waited_pushes += 1
                    loop.log.events.append(AsyncPushEvent(
                        worker=w, sim_time=now, version=v, result=res,
                        loss=loss, retries=0, wait_s=wait_s))
                    loop.accepted += 1
                    loop.parked.append(w)
                del group, results
                admit(now)

        drain(loop.now)
        admit(loop.now)
        while loop.accepted < target:
            ev = loop.queue.pop()
            t, w = ev.time, ev.worker
            version, loss, grads = ev.payload
            del ev
            loop.now = t
            loop.barrier.append((version, t, w, loss, grads))
            del grads
            drain(t)

    # ------------------------------------------------------------------
    # interop
    # ------------------------------------------------------------------

    def reset_loop(self) -> None:
        """Discard the event loop (clock, in-flight computations, log).

        Required after restoring the server from a checkpoint: in-flight
        computations hold gradients pinned at pre-restore versions and
        computed against pre-rollback weights — committing them against
        the restored parameters would silently corrupt the trajectory.
        The next ``run`` starts a fresh loop at simulated time 0.
        Error-feedback residuals are cleared too (they describe pushes of
        the discarded trajectory)."""
        self._loop = None
        self._residuals = {}

    @property
    def log(self) -> Optional[AsyncRunLog]:
        """The (cumulative) log of the current run, if one is active."""
        return self._loop.log if self._loop is not None else None

    def layer_params(self) -> List[Any]:
        """Head-version parameters, unflattened to the layer trees (views
        of the server's buffers)."""
        return [unflatten_tree(f, s)
                for f, s in zip(self.server.flats(), self.specs)]


@dataclasses.dataclass
class _LoopState:
    """Resumable discrete-event loop state.

    ``queue`` is the deterministic :class:`~repro_torch.fleet.engine.EventQueue`
    holding in-flight computations; each event's payload is ``(compute
    version, loss, per-layer gradient flats)`` and the engine's ``(time,
    seq, worker)`` key orders commits without ever comparing payloads.
    ``barrier`` holds completed-but-uncommitted computations (wait
    throttle) as ``(pin version, completion time, worker, loss, grads)``;
    ``parked`` holds workers awaiting admission, FIFO.
    """

    log: AsyncRunLog
    parked: List[int]
    queue: EventQueue = dataclasses.field(default_factory=EventQueue)
    barrier: List[Tuple[int, float, int, float, List[Any]]] = \
        dataclasses.field(default_factory=list)
    now: float = 0.0
    accepted: int = 0              # incremental len(log.accepted)
    attempts: Dict[int, int] = None
    retries: Dict[int, int] = None

    def __post_init__(self):
        if self.attempts is None:
            self.attempts = {w: 0 for w in self.parked}
        if self.retries is None:
            self.retries = {w: 0 for w in self.parked}
