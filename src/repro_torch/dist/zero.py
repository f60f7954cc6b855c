"""DynaComm-bucketed ZeRO trainer over a ``torch.distributed`` group.

A ``BucketPlan`` (from ``repro_torch.core.buckets``) drives a data-parallel
training step in which

* parameters live sharded as one padded flat float32 buffer per sched layer
  (``state["flat_params"][l]`` is this rank's ``(padded // A,)`` slice —
  ZeRO: master weights and optimizer moments are never replicated);
* the forward phase launches **exactly one all-gather per forward bucket**
  (the paper's parameter pull of a transmission segment);
* the backward phase walks the sched layers top down, recomputing each
  layer from its saved input and taking its vector-Jacobian product with
  ``torch.autograd.grad``, and launches **exactly one reduce-scatter per
  backward bucket** (the gradient push);
* with ``zero3=True`` the gathered weights of the middle layers are dropped
  after the forward: every backward bucket that contains a middle layer
  re-pulls its parameters with one extra all-gather (the first / last sched
  layers are exempt, as in the reference);
* with a ``compressor`` every push carries each rank's round-tripped
  (int8 or top-k) gradient instead of the gradient itself, and with error
  feedback the compression error of each (rank, layer) is kept in
  ``state["residuals"]`` and added to the next push.

The group is the caller's default group when one is initialised;
otherwise the trainer makes a world-1 group itself: NCCL for a CUDA
device, gloo for the CPU.  Each rank takes its ``1/A`` slice of the global
batch, as ``shard_map`` does in the reference.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.core.buckets import BucketPlan, flat_layer_order
from repro_torch.dist.collectives import (FlatSpec,
                                          compressed_reduce_scatter_bucket,
                                          flatten_tree, gather_bucket,
                                          make_flat_spec,
                                          reduce_scatter_bucket,
                                          unflatten_tree)
from repro_torch.models import blocks as blocks_lib
from repro_torch.models import model as model_lib
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import OptState


def default_group(device: torch.device):
    """The default process group, made world-1 here if none exists yet.

    The backend follows the device (NCCL for CUDA, gloo for the CPU); a
    group that exists with the other backend is refused rather than used.
    """
    backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_backend()
    if backend not in have:
        raise ValueError(f"the initialised process group runs {have!r}, "
                         f"which cannot serve tensors on {device}; "
                         f"initialise a {backend!r} group or pass group=")
    return dist.group.WORLD


def _vjp(fn: Callable, primals: Sequence[Any], cotangent) -> List[Any]:
    """Recompute ``fn(*primals)`` under autograd and pull ``cotangent``
    back to every primal tree (zeros where a primal is unused).

    ``fn`` may return a tuple of tensors, pulled back with a tuple of
    cotangents, as ``jax.vjp`` does.  A cotangent of ``None`` leaves its
    output out: a dense block's aux is a constant zero with no graph,
    which ``torch.autograd.grad`` refuses.  Every other output must carry
    a graph, or ``torch.autograd.grad`` raises: an MoE aux that lost its
    graph fails loudly instead of dropping the router's term."""
    vars_ = [tree.tree_map(lambda x: x.detach().requires_grad_(), p)
             for p in primals]
    with torch.enable_grad():
        out = fn(*vars_)
    if isinstance(out, tuple):
        pairs = [(o, c) for o, c in zip(out, cotangent) if c is not None]
        out = [o for o, _ in pairs]
        cotangent = [c for _, c in pairs]
    flat = [leaf for v in vars_ for leaf in tree.leaves(v)]
    grads = list(torch.autograd.grad(out, flat, grad_outputs=cotangent,
                                     allow_unused=True,
                                     materialize_grads=True))
    result, i = [], 0
    for v in vars_:
        n = len(tree.leaves(v))
        result.append(tree.unflatten(tree.structure(v), grads[i:i + n]))
        i += n
    return result


@dataclasses.dataclass
class ZeroTrainer:
    """Bucketed ZeRO data-parallel trainer over a process group."""

    cfg: ArchConfig
    plan: BucketPlan
    optimizer: Optimizer
    device: Any
    group: Optional[Any] = None
    zero3: bool = False
    aux_weight: float = 0.01
    compressor: Optional[Any] = None

    def __post_init__(self):
        if self.compressor is not None and self.compressor.scheme == "none":
            self.compressor = None        # identity: skip the wrapper math
        self.device = torch.device(self.device)
        if self.group is None:
            self.group = default_group(self.device)
        self.axis_size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.num_layers = model_lib.num_sched_layers(self.cfg)
        self._validate_plan()
        shapes = model_lib.param_shapes(self.cfg)
        self.specs: List[FlatSpec] = [
            make_flat_spec(t, self.axis_size)
            for t in model_lib.sched_layer_trees(shapes)]
        self._kinds = self.cfg.layer_kinds()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _validate_plan(self) -> None:
        Ls = self.num_layers
        fwd = flat_layer_order(self.plan.forward)
        bwd = flat_layer_order(self.plan.backward)
        if fwd != tuple(range(Ls)):
            raise ValueError(f"forward buckets {self.plan.forward} do not "
                             f"pull layers 0..{Ls - 1} in order")
        if bwd != tuple(range(Ls - 1, -1, -1)):
            raise ValueError(f"backward buckets {self.plan.backward} do not "
                             f"push layers {Ls - 1}..0 in order")

    def with_plan(self, plan: BucketPlan) -> "ZeroTrainer":
        """Same trainer driving a different bucket plan (the state layout
        depends only on the architecture and the group size)."""
        new = copy.copy(self)
        new.plan = plan
        new._validate_plan()
        return new

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    @property
    def _use_residuals(self) -> bool:
        return self.compressor is not None and self.compressor.error_feedback

    def _zero_residuals(self) -> List[torch.Tensor]:
        """Each rank's error-feedback carry: one ``(padded,)`` buffer per
        sched layer (row ``rank`` of the reference's ``(A, padded)``)."""
        return [torch.zeros(spec.padded, dtype=torch.float32,
                            device=self.device) for spec in self.specs]

    def _shard(self, flat: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
        w = spec.shard_size
        return flat[self.rank * w:(self.rank + 1) * w].clone()

    def state_from_flats(self, flats: Sequence[torch.Tensor],
                         mu: Optional[Sequence[torch.Tensor]] = None,
                         nu: Optional[Sequence[torch.Tensor]] = None,
                         step: int = 0,
                         residuals: Optional[Sequence[torch.Tensor]] = None
                         ) -> Dict[str, Any]:
        """A state from full ``(padded,)`` buffers (this rank keeps its
        shard); moments default to the optimizer's fresh ones, residuals
        (whole ``(A, padded)`` arrays: this rank keeps row ``rank``) to
        zero."""
        shards = [self._shard(f.to(self.device, torch.float32), s)
                  for f, s in zip(flats, self.specs)]
        opt = self.optimizer.init(shards)
        for mine, full in ((opt.mu, mu), (opt.nu, nu)):
            if full is not None:
                for buf, f, s in zip(mine, full, self.specs):
                    buf.copy_(self._shard(f.to(self.device), s))
        opt.step.fill_(step)
        state = {"flat_params": shards, "opt": opt,
                 "step": torch.full((), step, dtype=torch.int32,
                                    device=self.device)}
        if self._use_residuals:
            state["residuals"] = self._zero_residuals()
            if residuals is not None:
                for buf, whole in zip(state["residuals"], residuals):
                    buf.copy_(whole[self.rank])
        return state

    def init_state(self, gen: torch.Generator) -> Dict[str, Any]:
        """``init_params(cfg, gen)`` on the device, flattened and sharded."""
        params = model_lib.init_params(self.cfg, gen, torch.float32,
                                       self.device)
        trees = model_lib.sched_layer_trees(params)
        del params
        shards = []
        for i, spec in enumerate(self.specs):
            shards.append(self._shard(flatten_tree(trees[i], spec), spec))
            trees[i] = None                  # free the full layer now
        opt = self.optimizer.init(shards)
        state = {"flat_params": shards, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}
        if self._use_residuals:
            state["residuals"] = self._zero_residuals()
        return state

    def full_flat(self, shard: torch.Tensor) -> torch.Tensor:
        """All ranks' shards of one buffer, concatenated (not on the step
        path: checkpoints and interop)."""
        if self.axis_size == 1:
            return shard
        out = torch.empty(shard.numel() * self.axis_size, dtype=shard.dtype,
                          device=shard.device)
        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.group)
        return out

    def global_state(self, state) -> Dict[str, Any]:
        """The state with every sharded buffer made whole (rank-agnostic)."""
        opt: OptState = state["opt"]
        whole = (lambda bufs: None if bufs is None
                 else [self.full_flat(b) for b in bufs])
        out = {"flat_params": whole(state["flat_params"]),
               "opt": OptState(step=opt.step, mu=whole(opt.mu),
                               nu=whole(opt.nu)),
               "step": state["step"]}
        if "residuals" in state:          # (A, padded): row r is rank r's
            out["residuals"] = [self.full_flat(r).view(self.axis_size, -1)
                                for r in state["residuals"]]
        return out

    def local_state(self, whole) -> Dict[str, Any]:
        """Inverse of :meth:`global_state` for this rank."""
        opt = whole["opt"]
        state = self.state_from_flats(whole["flat_params"], opt.mu, opt.nu,
                                      int(opt.step), whole.get("residuals"))
        state["step"].fill_(int(whole["step"]))
        return state

    # ------------------------------------------------------------------
    # per-sched-layer applies (used forward AND in the recomputes)
    # ------------------------------------------------------------------

    def _apply_embed(self, embed_tree, batch):
        return model_lib._embed_inputs(self.cfg, {"embed": embed_tree}, batch)

    def _apply_block(self, block_tree, x, kind):
        y, _, aux = blocks_lib.apply_block(block_tree, x, self.cfg, kind,
                                           mode="train")
        return y, aux

    def _apply_final(self, final_tree, embed_tree, x, batch):
        """Final norm + (possibly embedding-tied) head + masked CE."""
        logits = model_lib._head(
            self.cfg, {"embed": embed_tree, "final": final_tree}, x)
        return model_lib.cross_entropy(logits, batch["labels"])

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------

    def _local_batch(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, x in batch.items():
            n = x.shape[0]
            if n % self.axis_size:
                raise ValueError(f"global batch {n} is not divisible by the "
                                 f"{self.axis_size} ranks of the group")
            w = n // self.axis_size
            out[k] = x[self.rank * w:(self.rank + 1) * w].to(self.device)
        return out

    def _gather(self, shards, bucket):
        return gather_bucket(shards, self.specs, bucket, self.group)

    def step(self, state, batch):
        """One training step; returns ``(state, mean loss)``.  The state's
        buffers are updated in place."""
        Ls, kinds = self.num_layers, self._kinds
        batch = self._local_batch(batch)
        shards = state["flat_params"]

        # ---- pull phase: one all-gather per forward bucket --------------
        full: Dict[int, Any] = {}
        for bucket in self.plan.forward:
            full.update(self._gather(shards, bucket))

        # ---- forward, saving each layer's input activation --------------
        acts: Dict[int, torch.Tensor] = {}
        with torch.no_grad():
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
            h = self._apply_embed(full[0], batch)
            for l in range(1, Ls - 1):
                acts[l] = h
                h, a = self._apply_block(full[l], h, kinds[l - 1])
                aux = aux + a
                if self.zero3:
                    del full[l]          # re-pulled for the backward
            acts[Ls - 1] = h
            ce = self._apply_final(full[Ls - 1], full[0], h, batch)
            loss = ce + self.aux_weight * aux
            del h

        # ---- backward: per-layer VJPs, one reduce-scatter per bucket ----
        aux_ct = (torch.full((), self.aux_weight, dtype=torch.float32,
                             device=self.device)
                  if self.cfg.is_moe else None)
        grad_shards: List[Optional[torch.Tensor]] = [None] * Ls
        embed_from_head = None     # tied-head contribution to the embedding
        ct_h = None                # cotangent w.r.t. the current activation
        for bucket in self.plan.backward:
            if self.zero3 and any(0 < l < Ls - 1 for l in bucket):
                full.update({l: p for l, p in
                             self._gather(shards, bucket).items()
                             if 0 < l < Ls - 1})
            bucket_grads: Dict[int, Any] = {}
            for l in bucket:       # descending layer order within the bucket
                if l == Ls - 1:
                    g_final, embed_from_head, ct_h = _vjp(
                        lambda pf, pe, hh: self._apply_final(pf, pe, hh,
                                                             batch),
                        (full[l], full[0], acts.pop(l)), None)
                    bucket_grads[l] = g_final
                elif l == 0:
                    (g_embed,) = _vjp(
                        lambda pe: self._apply_embed(pe, batch),
                        (full[0],), ct_h)
                    bucket_grads[l] = tree.tree_map(torch.add, g_embed,
                                                    embed_from_head)
                    embed_from_head = ct_h = None
                else:
                    kind = kinds[l - 1]
                    g_block, ct_h = _vjp(
                        lambda p, hh, _k=kind: self._apply_block(p, hh, _k),
                        (full[l], acts.pop(l)), (ct_h, aux_ct))
                    bucket_grads[l] = g_block
                if l != 0:
                    full.pop(l, None)     # this layer's weights are done
            if self.compressor is not None:
                pushed, _ = compressed_reduce_scatter_bucket(
                    bucket_grads, self.specs, bucket, self.group,
                    self.compressor,
                    residuals=({l: state["residuals"][l] for l in bucket}
                               if self._use_residuals else None))
            else:
                pushed = reduce_scatter_bucket(bucket_grads, self.specs,
                                               bucket, self.group)
            del bucket_grads
            for l, g in pushed.items():
                grad_shards[l] = g.div_(self.axis_size)   # sum → mean
        full.clear()

        # ---- sharded optimizer update (ZeRO: on local shards only) ------
        self.optimizer.update(grad_shards, state["opt"], shards)
        del grad_shards
        loss = loss.detach()
        if self.axis_size > 1:
            dist.all_reduce(loss, group=self.group)
            loss = loss / self.axis_size
        state["step"].add_(1)
        return state, loss

    # ------------------------------------------------------------------
    # interop
    # ------------------------------------------------------------------

    def params_from_state(self, state) -> Any:
        """The canonical (unsharded) parameter tree of a state —
        checkpoint / eval interop, not part of the hot path."""
        trees = [unflatten_tree(self.full_flat(flat), spec)
                 for flat, spec in zip(state["flat_params"], self.specs)]
        return model_lib.params_from_sched_layers(trees)
