"""Stage-partitioned pipeline-parallel trainer.

``PipelineTrainer`` executes the model as S contiguous stages of sched
layers (embed, blocks..., head — the :class:`StagePartition` decides the
split) in one process.  Micro-batch activations cross stage boundaries as
FlatSpec-described flat float32 buffers, handed to the next stage's device
with ``tensor.to``, and every crossing is accounted in a
:class:`~repro_torch.ps.server.TransferLedger` keyed by boundary index.
No collective runs inside a stage, and the trainer needs no process group.

Numerical contract — the losses are bitwise the same at M = 1 for any
stage count, and equal to the ZeRO step's on one rank, because every
stage runs the same per-layer ops in the same order; only the stage
boundaries move:

* forward (under ``no_grad``): ``_embed_inputs`` → ``apply_block``... →
  head, with the CE *numerator* accumulated per micro-batch and one
  division by the full-batch mask count at the end (at M = 1 this is
  ``cross_entropy``'s sum / clamp / divide);
* backward: per stage and micro-batch, the stage's forward recomputed
  under ``no_grad`` (each layer's input kept), then per-layer VJPs in
  descending order (``dist/zero.py::_vjp``, which recomputes the layer
  under autograd), with the tied-head embedding cotangent routed back to
  the stage that owns the embedding;
* gradients: each layer's gradient flattened as its VJP hands it back and
  added in place into that layer's accumulator, micro-batch by
  micro-batch;
* optimizer: the shared ``Optimizer.update`` on the per-sched-layer flat
  buffers, in place.

One grouping is built into the arithmetic: at M > 1 the tied embedding's
gradient is summed per micro-batch as ``e_m + h_m`` (embedding path plus
head path) when one stage holds both, and as ``Σe_m + Σh_m`` when the head
lies on a later stage.  So S = 1 and S > 1 agree to fp32 roundoff at
M > 1, and bitwise at M = 1 and between any two S > 1.

MoE auxiliary losses are summed per stage then combined in stage order,
and every block VJP pulls back the pair (output, aux) with the cotangent
``(ct_h, aux_weight / M)``.  With aux ≠ 0 and S > 1 the summation grouping
differs from S = 1, so MoE configs agree across S to fp32 roundoff rather
than bitwise (dense blocks emit a constant-zero aux and stay bitwise).

``stage_devices=`` places each stage's parameters, micro-batches and
boundary buffers on a device of its own (``.to`` before each stage call);
``None`` runs every stage on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.analysis.trace import record_collectives
from repro_torch.configs.base import ArchConfig
from repro_torch.core.costmodel import LayerCosts
from repro_torch.dist.collectives import (FlatSpec, flatten_tree,
                                          make_flat_spec, unflatten_tree)
from repro_torch.dist.zero import _vjp
from repro_torch.models import blocks as blocks_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import Optimizer
from repro_torch.pipeline.partition import StagePartition, partition_loads
from repro_torch.pipeline.schedule import (PipelineSchedule, PipelineTimeline,
                                           make_schedule, simulate)
from repro_torch.pipeline.transfer import (TransferPlan, boundary_costs,
                                           plan_boundary)
from repro_torch.ps.server import TransferLedger

#: ledger key for the tied-embedding broadcast to the head stage (the
#: one transfer that is not a neighbor-boundary crossing)
EMBED_LINK = -1


@dataclasses.dataclass
class PipelineTrainer:
    """S-stage pipeline execution of one model over micro-batches."""

    cfg: ArchConfig
    optimizer: Optimizer
    device: Any
    num_stages: int = 2
    num_microbatches: int = 1
    schedule_name: str = "1f1b"
    aux_weight: float = 0.01
    partition: Optional[StagePartition] = None   # default: uniform loads
    stage_devices: Optional[Sequence[Any]] = None
    planner: Optional[Any] = None                # transfer-planning seam
    transfer_strategy: str = "dynacomm"
    costs: Optional[LayerCosts] = None           # for timeline()/plans
    net: Optional[Any] = None                    # EdgeNetworkModel-like
    transfer_chunks: int = 1

    rank = 0          # one process holds every stage: its state is whole

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.num_layers = model_lib.num_sched_layers(self.cfg)
        if not 1 <= self.num_stages <= self.num_layers:
            raise ValueError(
                f"num_stages must be in [1, {self.num_layers}] "
                f"(sched layers), got {self.num_stages}")
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got "
                             f"{self.num_microbatches}")
        if self.partition is None:
            self.partition = partition_loads(
                [1.0] * self.num_layers, self.num_stages)
        if self.partition.num_stages != self.num_stages or \
                self.partition.num_layers != self.num_layers:
            raise ValueError(
                f"partition covers {self.partition.num_layers} layers in "
                f"{self.partition.num_stages} stages; trainer wants "
                f"{self.num_layers} layers in {self.num_stages} stages")
        if self.stage_devices is not None:
            if len(self.stage_devices) != self.num_stages:
                raise ValueError("need one device per stage")
            self.stage_devices = [torch.device(d)
                                  for d in self.stage_devices]
        self.schedule: PipelineSchedule = make_schedule(
            self.schedule_name, self.num_stages, self.num_microbatches)
        self.specs: List[FlatSpec] = [
            make_flat_spec(t, 1) for t in
            model_lib.sched_layer_trees(model_lib.param_shapes(self.cfg))]
        self._kinds = self.cfg.layer_kinds()
        self._ledger = TransferLedger()
        self._bspecs: Optional[List[FlatSpec]] = None   # per boundary
        self._transfer_plans: Optional[List[TransferPlan]] = None

    # ------------------------------------------------------------------
    # per-sched-layer applies (the ZeroTrainer's math)
    # ------------------------------------------------------------------

    def _apply_embed(self, embed_tree, batch):
        return model_lib._embed_inputs(self.cfg, {"embed": embed_tree}, batch)

    def _apply_block(self, block_tree, x, kind):
        y, _, aux = blocks_lib.apply_block(block_tree, x, self.cfg, kind,
                                           mode="train")
        return y, aux

    def _ce_num(self, final_tree, embed_tree, x, batch):
        """The numerator of ``cross_entropy`` — same ops, no division."""
        logits = model_lib._head(
            self.cfg, {"embed": embed_tree, "final": final_tree}, x)
        labels = batch["labels"].long()
        mask = (labels >= 0).float()
        safe = labels.clamp(min=0)
        x32 = logits.float()
        m = x32.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(x32 - m).sum(dim=-1)) + m[..., 0]
        picked = x32.gather(-1, safe[..., None])[..., 0]
        return ((lse - picked) * mask).sum()

    def _mask_den(self, batch):
        """``cross_entropy``'s denominator from the full batch's labels."""
        mask = (batch["labels"].long() >= 0).float()
        return torch.clamp(mask.sum(), min=1.0)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def init_state(self, gen: torch.Generator) -> Dict[str, Any]:
        """``init_params(cfg, gen)`` on the device, flattened (the ZeRO
        step's initial weights on one rank)."""
        params = model_lib.init_params(self.cfg, gen, torch.float32,
                                       self.device)
        trees = model_lib.sched_layer_trees(params)
        del params
        flats = []
        for i, spec in enumerate(self.specs):
            flats.append(flatten_tree(trees[i], spec))
            trees[i] = None                  # free the layer's tree now
        return self._place_state(self._new_state(flats, 0))

    def _new_state(self, flats: List[torch.Tensor], step: int
                   ) -> Dict[str, Any]:
        opt = self.optimizer.init(flats)
        opt.step.fill_(step)
        return {"flat_params": flats, "opt": opt,
                "step": torch.full((), step, dtype=torch.int32,
                                   device=self.device)}

    def state_from_flats(self, flats: Sequence[torch.Tensor],
                         mu: Optional[Sequence[torch.Tensor]] = None,
                         nu: Optional[Sequence[torch.Tensor]] = None,
                         step: int = 0) -> Dict[str, Any]:
        """A state from whole ``(padded,)`` buffers (copied onto the
        device); moments default to the optimizer's fresh ones."""
        state = self._new_state(
            [f.to(self.device, torch.float32, copy=True) for f in flats],
            step)
        opt = state["opt"]
        for mine, given in ((opt.mu, mu), (opt.nu, nu)):
            if given is not None:
                for buf, f in zip(mine, given):
                    buf.copy_(f)
        return self._place_state(state)

    def global_state(self, state) -> Dict[str, Any]:
        """The whole state (one process holds every stage)."""
        return state

    def local_state(self, whole) -> Dict[str, Any]:
        """Inverse of :meth:`global_state`."""
        opt = whole["opt"]
        state = self.state_from_flats(whole["flat_params"], opt.mu, opt.nu,
                                      int(opt.step))
        state["step"].fill_(int(whole["step"]))
        return state

    def _place_state(self, state):
        """Pin each stage's buffers to its device when stages are placed."""
        if self.stage_devices is None:
            return state
        stage_of = self.partition.stage_of
        state = dict(state)
        state["flat_params"] = [
            f.to(self.stage_devices[stage_of[l]])
            for l, f in enumerate(state["flat_params"])]
        return state

    def params_from_state(self, state) -> Any:
        trees = [unflatten_tree(f, spec)
                 for f, spec in zip(state["flat_params"], self.specs)]
        return model_lib.params_from_sched_layers(trees)

    # ------------------------------------------------------------------
    # boundary layouts
    # ------------------------------------------------------------------

    def prepare(self, batch) -> None:
        """Derive each boundary's FlatSpec from ``batch``'s shapes, without
        running a step (the first step calls this).  The embedding's
        output is probed on the ``meta`` device; every block maps the
        residual stream to its own shape, so each boundary carries that
        shape (the step checks each real boundary tensor against it)."""
        if self._bspecs is not None:
            return
        micro = self._split(batch)[0]
        embed = unflatten_tree(
            torch.empty(self.specs[0].padded, device="meta"), self.specs[0])
        h = self._apply_embed(embed, {k: v.to("meta")
                                      for k, v in micro.items()})
        self._bspecs = [make_flat_spec(h, 1)] * (self.num_stages - 1)

    def _to_boundary(self, h: torch.Tensor, b: int) -> torch.Tensor:
        spec = self._bspecs[b]
        if (tuple(h.shape), h.dtype) != (spec.shapes[0], spec.dtypes[0]):
            raise ValueError(f"boundary {b} carries {tuple(h.shape)} "
                             f"{h.dtype}, its layout says "
                             f"{spec.shapes[0]} {spec.dtypes[0]}")
        return flatten_tree(h, spec)

    # ------------------------------------------------------------------
    # one stage, one micro-batch
    # ------------------------------------------------------------------

    def _device_of(self, s: int) -> torch.device:
        return self.device if self.stage_devices is None \
            else self.stage_devices[s]

    def _stage_trees(self, state, s: int) -> Dict[int, Any]:
        """Stage ``s``'s layer trees: views of its flats on its device."""
        return {l: unflatten_tree(self._put(state["flat_params"][l], s),
                                  self.specs[l])
                for l in self.partition.layers_of(s)}

    def _stage_forward(self, s, trees, h_in, mb, embed_tree):
        """Stage s on one micro-batch: the boundary flat it emits (the CE
        numerator on the last stage) and its summed aux loss."""
        layers = self.partition.layers_of(s)
        Ls = self.num_layers
        if 0 in layers:
            h = self._apply_embed(trees[0], mb)
        else:
            h = unflatten_tree(h_in, self._bspecs[s - 1])
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for l in layers:
            if l == 0 or l == Ls - 1:
                continue
            h, a = self._apply_block(trees[l], h, self._kinds[l - 1])
            aux = aux + a
        if (Ls - 1) in layers:
            return self._ce_num(trees[Ls - 1], embed_tree, h, mb), aux
        return self._to_boundary(h, s), aux

    def _stage_backward(self, s, trees, h_in, mb, embed_tree, den, ct_in,
                        acc):
        """Stage s's backward on one micro-batch: recompute the stage's
        forward keeping each layer's input, then the descending per-layer
        VJPs, each gradient flattened and accumulated into ``acc`` as it
        comes.  Returns the cotangent flat of the incoming boundary and,
        when the head lies here but the embedding does not, the head's
        embedding gradient flat (``None`` where there is none)."""
        layers = self.partition.layers_of(s)
        Ls, kinds = self.num_layers, self._kinds
        has_embed, has_head = 0 in layers, (Ls - 1) in layers

        acts: Dict[int, torch.Tensor] = {}
        with torch.no_grad():
            if has_embed:
                h = self._apply_embed(trees[0], mb)
            else:
                h = unflatten_tree(h_in, self._bspecs[s - 1])
            for l in layers:
                if l == 0 or l == Ls - 1:
                    continue
                acts[l] = h
                h, _ = self._apply_block(trees[l], h, kinds[l - 1])
            if has_head:
                acts[Ls - 1] = h
            del h

        ct_h = None if has_head else unflatten_tree(ct_in,
                                                    self._bspecs[s])
        aux_ct = (torch.full((), self.aux_weight / self.num_microbatches,
                             dtype=torch.float32, device=self._device_of(s))
                  if self.cfg.is_moe else None)
        embed_from_head = None
        for l in reversed(layers):
            if l == Ls - 1:
                g, embed_from_head, ct_h = _vjp(
                    lambda pf, pe, hh: self._ce_num(pf, pe, hh, mb) / den,
                    (trees[l], embed_tree, acts.pop(l)), None)
            elif l == 0:
                (g,) = _vjp(lambda pe: self._apply_embed(pe, mb),
                            (trees[0],), ct_h)
                if embed_from_head is not None:   # head in the same stage
                    g = tree.tree_map(torch.add, g, embed_from_head)
                    embed_from_head = None
            else:
                g, ct_h = _vjp(
                    lambda p, hh, _k=kinds[l - 1]: self._apply_block(p, hh,
                                                                     _k),
                    (trees[l], acts.pop(l)), (ct_h, aux_ct))
            _accumulate(acc, l, flatten_tree(g, self.specs[l]))
            del g
        ct_out = None if has_embed else flatten_tree(ct_h,
                                                     self._bspecs[s - 1])
        if embed_from_head is not None:
            embed_from_head = flatten_tree(embed_from_head, self.specs[0])
        return ct_out, embed_from_head

    def stage_traces(self, state, batch) -> List[Tuple[list, list]]:
        """Each stage's (forward, backward) collective trace.

        Runs the first micro-batch of ``batch`` through every stage's
        forward, then every stage's backward, each under
        :func:`~repro_torch.analysis.trace.record_collectives` (the port
        has no per-stage program to lower, as the reference's
        ``stage_hlo`` does).  The conformance pass asserts each trace
        empty: every inter-stage byte moves through the boundary buffers
        the ledger accounts, never through a collective.  The gradients go
        to a scratch accumulator: the state, the ledger and the step count
        are left as they were."""
        self.prepare(batch)
        S = self.num_stages
        mb = self._split(batch)[0]
        mbs = [self._put(mb, s) if s in (0, S - 1) else None
               for s in range(S)]
        den = self._mask_den(self._put(batch, S - 1))
        stage_trees = [self._stage_trees(state, s) for s in range(S)]
        embed_tree = stage_trees[0][0] if S == 1 else unflatten_tree(
            self._put(state["flat_params"][0], S - 1), self.specs[0])
        fwd, h_in, h = [], [], None
        with torch.no_grad():
            for s in range(S):
                h_in.append(h)
                with record_collectives() as trace:
                    out, _ = self._stage_forward(s, stage_trees[s], h,
                                                 mbs[s], embed_tree)
                fwd.append(trace)
                h = self._put(out, s + 1) if s < S - 1 else None
        acc: List[Optional[torch.Tensor]] = [None] * self.num_layers
        bwd: List[list] = [[] for _ in range(S)]
        ct = None
        for s in reversed(range(S)):
            with record_collectives() as trace:
                ct, _ = self._stage_backward(s, stage_trees[s], h_in[s],
                                             mbs[s], embed_tree, den, ct,
                                             acc)
            bwd[s] = trace
            if s > 0:
                ct = self._put(ct, s - 1)
        return list(zip(fwd, bwd))

    # ------------------------------------------------------------------
    # the train step (host-driven per-stage pipeline)
    # ------------------------------------------------------------------

    def _split(self, batch) -> List[Any]:
        M = self.num_microbatches
        b0 = tree.leaves(batch)[0].shape[0]
        if b0 % M:
            raise ValueError(f"batch size {b0} not divisible by "
                             f"{M} micro-batches")
        mbs = b0 // M
        return [{k: x[m * mbs:(m + 1) * mbs] for k, x in batch.items()}
                for m in range(M)]

    def _put(self, x, s: int):
        """``x`` (a tensor or a tree of them) on stage ``s``'s device."""
        dev = self._device_of(s)
        return tree.tree_map(lambda t: t.to(dev), x)

    def step(self, state, batch):
        """One optimizer step; returns ``(state, loss)``.  The state's
        buffers are updated in place.

        Forward then backward over all micro-batches, stage by stage on
        the host; the :class:`PipelineSchedule` orders the same task set
        on real hardware (and prices it in :meth:`timeline`) — the loss
        and gradients are order-invariant, so the host replay executes
        stages in dependency order."""
        self.prepare(batch)
        S, M, Ls = self.num_stages, self.num_microbatches, self.num_layers
        # micro-batches on the stages that read them (embedding, head)
        mbs = [[self._put(mb, s) if s in (0, S - 1) else None
                for mb in self._split(batch)] for s in range(S)]
        den = self._mask_den(self._put(batch, S - 1))
        stage_trees = [self._stage_trees(state, s) for s in range(S)]
        embed_tree = stage_trees[0][0]
        if S > 1:
            embed_tree = unflatten_tree(
                self._put(state["flat_params"][0], S - 1), self.specs[0])
            self._ledger.record_pull(EMBED_LINK, self.specs[0].total * 4)

        # ---- forward: boundary activations flow down the stages --------
        bnd: List[List[torch.Tensor]] = [[] for _ in range(M)]
        nums, auxs = [], []
        with torch.no_grad():
            for m in range(M):
                h = None
                for s in range(S):
                    out, aux = self._stage_forward(
                        s, stage_trees[s], h, mbs[s][m], embed_tree)
                    auxs.append(aux)
                    if s < S - 1:
                        h = self._put(out, s + 1)
                        bnd[m].append(h)
                        self._ledger.record_pull(s,
                                                 self._bspecs[s].total * 4)
                    else:
                        nums.append(out)

        # ---- backward: per-stage VJPs, activation grads flow back ------
        acc: List[Optional[torch.Tensor]] = [None] * Ls
        embed_home = None
        for m in range(M):
            ct = None
            for s in reversed(range(S)):
                ct, efh = self._stage_backward(
                    s, stage_trees[s], bnd[m][s - 1] if s > 0 else None,
                    mbs[s][m], embed_tree, den, ct, acc)
                if s > 0:
                    ct = self._put(ct, s - 1)
                    self._ledger.record_push(
                        s - 1, self._bspecs[s - 1].total * 4)
                if efh is not None:
                    self._ledger.record_push(EMBED_LINK,
                                             self.specs[0].total * 4)
                    efh = self._put(efh, 0)
                    if embed_home is None:
                        embed_home = efh
                    else:
                        embed_home.add_(efh)
            bnd[m] = None
        if embed_home is not None:
            acc[0].add_(embed_home)
        del bnd, mbs, stage_trees, embed_tree, embed_home

        # ---- combine loss + shared optimizer update --------------------
        num = self._put(nums[0], 0)
        for x in nums[1:]:
            num = num + self._put(x, 0)
        aux = self._put(auxs[0], 0)
        for a in auxs[1:]:
            aux = aux + self._put(a, 0)
        aw = torch.full((), self.aux_weight / M, dtype=torch.float32,
                        device=aux.device)
        loss = num / self._put(den, 0) + aw * aux

        flats, opt = state["flat_params"], state["opt"]
        if self.stage_devices is not None:
            flats, acc, opt = self._put((flats, acc, opt), 0)
        flats, opt = self.optimizer.update(acc, opt, flats)
        del acc
        state = self._place_state({"flat_params": flats, "opt": opt,
                                   "step": state["step"]})
        state["step"].add_(1)
        return state, loss

    # ------------------------------------------------------------------
    # accounting / cost-model views
    # ------------------------------------------------------------------

    @property
    def ledger(self) -> Dict[str, Any]:
        led = self._ledger
        return {"pull_bytes": sum(led.pulled_bytes.values()),
                "push_bytes": sum(led.pushed_bytes.values()),
                "pull_wire_bytes": sum(led.pulled_wire_bytes.values()),
                "push_wire_bytes": sum(led.pushed_wire_bytes.values()),
                "num_pulls": led.num_pulls,
                "num_pushes": led.num_pushes,
                "boundary_pull_bytes": dict(led.pulled_bytes),
                "boundary_push_bytes": dict(led.pushed_bytes)}

    def stage_times(self, costs: LayerCosts) -> Tuple[List[float],
                                                      List[float]]:
        """Per-stage per-micro-batch (fwd, bwd) seconds from cost vectors."""
        M = self.num_microbatches
        fwd, bwd = [], []
        for s in range(self.num_stages):
            ls = self.partition.layers_of(s)
            fwd.append(float(sum(costs.fc[l] for l in ls)) / M)
            bwd.append(float(sum(costs.bc[l] for l in ls)) / M)
        return fwd, bwd

    def activation_bytes(self) -> List[int]:
        """Per-boundary micro-batch activation bytes (needs a step or
        :meth:`prepare`: boundary shapes come from the first batch)."""
        if self._bspecs is None:
            raise RuntimeError("no boundary specs yet: run a step first")
        return [spec.total * 4 for spec in self._bspecs]

    def transfer_plans(self) -> Optional[List[TransferPlan]]:
        """DynaComm-segmented plan per boundary (None before first step
        or without ``costs``/``net``)."""
        if self._transfer_plans is not None:
            return self._transfer_plans
        if self.costs is None or self.net is None or self._bspecs is None:
            return None
        fwd, bwd = self.stage_times(self.costs)
        plans = []
        for b, nbytes in enumerate(self.activation_bytes()):
            c = boundary_costs(nbytes, self.num_microbatches, net=self.net,
                               stage_fwd_s=fwd[b + 1], stage_bwd_s=bwd[b + 1],
                               chunks=self.transfer_chunks)
            plans.append(plan_boundary(b, c, planner=self.planner,
                                       strategy=self.transfer_strategy,
                                       microbatches=self.num_microbatches,
                                       chunks=self.transfer_chunks))
        self._transfer_plans = plans
        return plans

    def timeline(self) -> Optional[PipelineTimeline]:
        """Simulated replay of the active schedule under the cost model,
        with DynaComm-segmented effective boundary waits."""
        if self.costs is None:
            return None
        fwd, bwd = self.stage_times(self.costs)
        plans = self.transfer_plans()
        if plans:
            fx = [p.effective_waits[0] for p in plans]
            bx = [p.effective_waits[1] for p in plans]
        else:
            fx = bx = None
        return simulate(self.schedule, fwd, bwd,
                        fwd_transfer=fx, bwd_transfer=bx)


def _accumulate(acc: List[Optional[torch.Tensor]], l: int,
                g: torch.Tensor) -> None:
    """``acc[l] = g`` the first time, else ``acc[l] += g`` in place (the
    same bits as ``acc[l] + g``)."""
    if acc[l] is None:
        acc[l] = g
    else:
        acc[l].add_(g)
