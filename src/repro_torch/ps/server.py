"""Server-side parameter state: versioned partitions, segmented push/pull.

``PSServer`` is the authoritative copy of the model in the PS execution
subsystem.  Parameters live as one padded flat float32 buffer per sched
layer (the same ``FlatSpec`` layout the dist layer uses, so worker-side
code reuses ``flatten_tree``/``unflatten_tree`` unchanged), grouped by
owning server shard per :class:`repro_torch.ps.topology.PSTopology`.

Protocol (one message per DynaComm transmission segment):

* **pull** — ``pull_bucket(bucket, version=v)`` serves the segment's layer
  buffers from the *versioned snapshot* ``v``, so a worker whose
  segmented pull is interleaved with other workers' pushes still
  assembles a consistent parameter set (all segments from one version);
* **push** — ``push_bucket(worker, version, bucket, grads)`` accumulates
  the segment's gradients; when the last segment of the plan arrives the
  push *commits*: the bounded-staleness rule (``server.version − v ≤ k``)
  accepts or rejects it atomically, an accepted commit runs the server
  optimizer and bumps the version.

The server keeps the last ``staleness_bound + 1`` versions; pulling an
evicted version raises :class:`StaleVersion` — the worker must re-pull at
the head version.

**Snapshots own their bytes.**  The port's optimizers update the buffers
in place (``repro_torch.optim``), so the head version lives in the live
buffers and every older version the window still serves is a clone,
taken just before the commit that overwrites it — after the versions
below the new floor are evicted, so the server never holds more than
``staleness_bound`` clones beside the head (``1 + k`` parameter copies,
as in the reference; none at ``k = 0``).  A pull hands out the server's
own buffers: the head's buffers change at the next commit, so a caller
that keeps them past a commit re-pulls at its pinned version instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.collectives import FLAT_DTYPE, FlatSpec, bucket_bytes
from repro_torch.optim import Optimizer
from repro_torch.ps.topology import PSTopology


class StaleVersion(RuntimeError):
    """Requested snapshot version has been evicted (staleness window)."""


@dataclasses.dataclass(frozen=True)
class PushResult:
    """Outcome of a committed (fully pushed) gradient set."""

    worker: int
    accepted: bool
    staleness: int            # server.version − compute version, at commit
    version: int              # server version after the commit


@dataclasses.dataclass
class TransferLedger:
    """Per-worker byte/message accounting, split by direction.

    Tracks *logical* bytes (the fp32 payload the training step produced)
    and *wire* bytes (what actually crossed the link after compression)
    separately; without a compressor the two coincide.
    """

    pulled_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    pushed_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    pulled_wire_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    pushed_wire_bytes: Dict[int, int] = dataclasses.field(default_factory=dict)
    num_pulls: int = 0
    num_pushes: int = 0
    rejected_pushes: int = 0
    waited_pushes: int = 0        # SSP wait-throttle: commits that blocked
    migrated_bytes: int = 0       # re-sharding: params + opt state moved
    num_reshards: int = 0

    def record_migration(self, nbytes: int) -> None:
        """Account one re-shard's server-to-server state movement."""
        self.migrated_bytes += nbytes
        self.num_reshards += 1

    def record_pull(self, worker: int, nbytes: int,
                    wire_bytes: Optional[int] = None) -> None:
        wire = nbytes if wire_bytes is None else wire_bytes
        self.pulled_bytes[worker] = self.pulled_bytes.get(worker, 0) + nbytes
        self.pulled_wire_bytes[worker] = \
            self.pulled_wire_bytes.get(worker, 0) + wire
        self.num_pulls += 1

    def record_push(self, worker: int, nbytes: int,
                    wire_bytes: Optional[int] = None) -> None:
        wire = nbytes if wire_bytes is None else wire_bytes
        self.pushed_bytes[worker] = self.pushed_bytes.get(worker, 0) + nbytes
        self.pushed_wire_bytes[worker] = \
            self.pushed_wire_bytes.get(worker, 0) + wire
        self.num_pushes += 1

    def compression_ratio(self, direction: str = "push",
                          worker: Optional[int] = None) -> float:
        """logical/wire byte ratio (>1 means smaller on the wire) for one
        direction, fleet-wide or for a single worker; 1.0 with no traffic."""
        if direction == "push":
            logical, wire = self.pushed_bytes, self.pushed_wire_bytes
        elif direction == "pull":
            logical, wire = self.pulled_bytes, self.pulled_wire_bytes
        else:
            raise ValueError(f"direction must be 'push' or 'pull', got "
                             f"{direction!r}")
        workers = logical.keys() if worker is None else [worker]
        num = sum(logical.get(w, 0) for w in workers)
        den = sum(wire.get(w, 0) for w in workers)
        return num / den if den else 1.0


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def _check_flats(flats: Sequence[torch.Tensor],
                 specs: Sequence[FlatSpec]) -> None:
    if len(flats) != len(specs):
        raise ValueError(f"{len(flats)} buffers for {len(specs)} specs")
    for l, (flat, spec) in enumerate(zip(flats, specs)):
        if tuple(flat.shape) != (spec.padded,):
            raise ValueError(f"layer {l} buffer shape {tuple(flat.shape)} "
                             f"!= ({spec.padded},)")


class PSServer:
    """Sharded, versioned parameter store with a bounded-staleness gate.

    The server takes ``init_flats`` as its head buffers (float32 buffers
    are used as they are, not copied) and updates them in place.
    """

    def __init__(self, specs: Sequence[FlatSpec], topology: PSTopology,
                 optimizer: Optimizer, init_flats: Sequence[torch.Tensor], *,
                 staleness_bound: int = 0, compressor=None):
        if compressor is not None and compressor.scheme == "none":
            compressor = None
        if staleness_bound < 0:
            raise ValueError(f"staleness_bound must be >= 0, got "
                             f"{staleness_bound}")
        _check_flats(init_flats, specs)
        self.specs = tuple(specs)
        self.topology = topology
        self.optimizer = optimizer
        self.staleness_bound = staleness_bound
        self.compressor = compressor
        self._flats: List[torch.Tensor] = [f.to(FLAT_DTYPE)
                                           for f in init_flats]
        self._opt_state = optimizer.init(self._flats)
        self.version = 0
        # versions below the head that the window still serves (clones)
        self._snapshots: Dict[int, Tuple[torch.Tensor, ...]] = {}
        # pending segmented pushes: (worker, version) → {layer: grad flat}
        self._pending: Dict[Tuple[int, int], Dict[int, torch.Tensor]] = {}
        self.ledger = TransferLedger()

    @property
    def num_layers(self) -> int:
        return len(self.specs)

    # ------------------------------------------------------------------
    # pull: parameters down, one message per segment
    # ------------------------------------------------------------------

    def segment_bytes(self, bucket: Sequence[int]) -> int:
        """Payload of one segment message (unpadded f32 bytes)."""
        return bucket_bytes(self.specs, bucket)

    def push_wire_bytes(self, bucket: Sequence[int]) -> int:
        """Bytes one segment's push puts on the uplink: per-layer
        compressed payloads plus the per-segment header; equals
        ``segment_bytes`` without a compressor."""
        if self.compressor is None:
            return self.segment_bytes(bucket)
        wire = sum(float(self.compressor.wire_bytes(self.specs[l].total * 4))
                   for l in bucket)
        return int(round(wire + self.compressor.segment_overhead_bytes))

    def _version_buffers(self, v: int) -> Sequence[torch.Tensor]:
        if v == self.version:
            return self._flats
        if v not in self._snapshots:
            raise StaleVersion(
                f"version {v} evicted (head {self.version}, window "
                f"{self.staleness_bound}); re-pull at the head version")
        return self._snapshots[v]

    def pull_bucket(self, bucket: Sequence[int], *,
                    version: Optional[int] = None,
                    worker: Optional[int] = None
                    ) -> Tuple[int, Dict[int, torch.Tensor]]:
        """Serve one segment from snapshot ``version`` (default: head).

        Returns ``(version, {layer: flat buffer})``.  Workers pin the
        version of their first segment and pass it for the rest of the
        plan, getting a consistent parameter set under concurrent pushes.
        """
        if not bucket:
            raise ValueError("cannot pull an empty segment")
        v = self.version if version is None else version
        snap = self._version_buffers(v)
        out = {l: snap[l] for l in bucket}
        if worker is not None:
            self.ledger.record_pull(worker, self.segment_bytes(bucket))
        return v, out

    # ------------------------------------------------------------------
    # push: gradients up, one message per segment, commit on the last
    # ------------------------------------------------------------------

    def push_bucket(self, worker: int, version: int, bucket: Sequence[int],
                    grads: Dict[int, torch.Tensor]
                    ) -> Optional[PushResult]:
        """Accumulate one segment's gradients; commit when complete.

        Returns ``None`` while segments are outstanding, a
        :class:`PushResult` once all ``num_layers`` gradients arrived —
        rejected pushes (staleness beyond the bound at commit time)
        discard the pending set without touching the parameters.
        """
        missing = [l for l in bucket if l not in grads]
        if missing:
            raise ValueError(f"push of bucket {tuple(bucket)} lacks grads "
                             f"for layers {missing}")
        key = (worker, version)
        pending = self._pending.setdefault(key, {})
        for l in bucket:
            if l in pending:
                raise ValueError(f"layer {l} pushed twice by worker "
                                 f"{worker} at version {version}")
            pending[l] = grads[l].to(FLAT_DTYPE)
        self.ledger.record_push(worker, self.segment_bytes(bucket),
                                wire_bytes=self.push_wire_bytes(bucket))
        if len(pending) < self.num_layers:
            return None
        del self._pending[key]
        staleness = self.version - version
        if staleness > self.staleness_bound:
            self.ledger.rejected_pushes += 1
            return PushResult(worker=worker, accepted=False,
                              staleness=staleness, version=self.version)
        grad_list = [pending.pop(l) for l in range(self.num_layers)]
        self._commit(grad_list)
        return PushResult(worker=worker, accepted=True, staleness=staleness,
                          version=self.version)

    def push_aggregated(self, pushes: Sequence[
            Tuple[int, int, Dict[int, torch.Tensor]]]) -> List[PushResult]:
        """Commit several *same-version* complete gradient sets as ONE
        optimizer step (the SSP wait throttle's BSP aggregation mode).

        ``pushes`` is a sequence of ``(worker, version, {layer: grad
        flat})`` entries, every one covering all ``num_layers`` layers and
        pinned at the same version.  The bounded-staleness gate applies to
        the shared version once; an accepted group applies the *mean* of
        the gradients — summed in worker order and divided once, as the
        reference sums — and bumps the version once.  Returns one
        :class:`PushResult` per entry, in order.
        """
        if not pushes:
            raise ValueError("cannot aggregate an empty push group")
        versions = {v for _, v, _ in pushes}
        if len(versions) != 1:
            raise ValueError(f"aggregated pushes must share one version, "
                             f"got {sorted(versions)}")
        (version,) = versions
        for worker, _, grads in pushes:
            missing = [l for l in range(self.num_layers) if l not in grads]
            if missing:
                raise ValueError(f"worker {worker}'s aggregated push lacks "
                                 f"grads for layers {missing}")
        staleness = self.version - version
        if staleness > self.staleness_bound:
            self.ledger.rejected_pushes += len(pushes)
            return [PushResult(worker=w, accepted=False,
                               staleness=staleness, version=self.version)
                    for w, _, _ in pushes]
        n = len(pushes)
        mean: List[torch.Tensor] = []
        for l in range(self.num_layers):
            acc = pushes[0][2][l].to(FLAT_DTYPE)
            for _, _, grads in pushes[1:]:
                acc = acc + grads[l].to(FLAT_DTYPE)
            mean.append(acc / n)
        self._commit(mean)
        return [PushResult(worker=w, accepted=True, staleness=staleness,
                           version=self.version) for w, _, _ in pushes]

    def _commit(self, grads: List[torch.Tensor]) -> None:
        """Apply one optimizer step and bump the version: evict the
        versions below the new floor, keep the current head as a clone if
        the window still serves it, then update the head in place."""
        new = self.version + 1
        floor = new - self.staleness_bound
        for v in [v for v in self._snapshots if v < floor]:
            del self._snapshots[v]
        if self.version >= floor:
            self._snapshots[self.version] = tuple(f.clone()
                                                  for f in self._flats)
        self._flats, self._opt_state = self.optimizer.update(
            grads, self._opt_state, self._flats)
        self.version = new

    def head_distance(self, version: int) -> int:
        """Staleness a push computed at ``version`` would have if it
        committed *now* (the quantity the bounded-staleness gate compares
        against ``staleness_bound``)."""
        return self.version - version

    def drop_pending(self, worker: int) -> int:
        """Discard every uncommitted segmented push of ``worker`` (crash /
        departure cleanup); returns how many pending sets were dropped.
        Segment bytes already on the wire stay in the ledger — a crashed
        worker's partial push cost real uplink traffic."""
        keys = [k for k in self._pending if k[0] == worker]
        for k in keys:
            del self._pending[k]
        return len(keys)

    # ------------------------------------------------------------------
    # elastic re-sharding
    # ------------------------------------------------------------------

    def reshard(self, topology: PSTopology) -> Dict[str, int]:
        """Re-partition the layers across ``topology``'s server shards
        **without losing versioned state**.

        Shard ownership is a pure view over the per-layer buffers
        (:meth:`shard_view`), so splitting or merging shards moves layer
        state between servers but never rewrites it: the head parameters,
        every retained snapshot, the optimizer moments, and the version
        counter are all bitwise unchanged by the call.  What *does* cost
        something is the migration itself: every layer whose owning shard
        changed ships its parameters plus its optimizer moment slots
        server-to-server, accounted in ``ledger.migrated_bytes``.

        Returns ``{"moved_layers": n, "migrated_bytes": b,
        "num_servers": S}``.  The new topology may also change the worker
        set — shard routing only depends on ``num_servers``.
        """
        old_owner = {l: self.topology.shard_of_layer(l, self.num_layers)
                     for l in range(self.num_layers)}
        self.topology = topology
        moved = [l for l in range(self.num_layers)
                 if topology.shard_of_layer(l, self.num_layers)
                 != old_owner[l]]
        # per-layer moment slots present under this optimizer (SGD: 0,
        # momentum: 1, AdamW: 2) — each is parameter-sized fp32
        slots = sum(1 for m in (self._opt_state.mu, self._opt_state.nu)
                    if m is not None)
        migrated = sum(self.specs[l].total * 4 for l in moved) * (1 + slots)
        self.ledger.record_migration(migrated)
        return {"moved_layers": len(moved), "migrated_bytes": migrated,
                "num_servers": topology.num_servers}

    # ------------------------------------------------------------------
    # checkpointing (``repro_torch.runtime`` save_state/restore_state)
    # ------------------------------------------------------------------

    def _state_tree(self, leaf) -> Dict[str, object]:
        """The checkpoint tree (the reference's keys) with ``leaf`` applied
        to every buffer."""
        opt = self._opt_state

        def moments(ms):
            return None if ms is None else [leaf(m) for m in ms]
        return {"flats": [leaf(f) for f in self._flats],
                "opt": opt._replace(step=leaf(opt.step), mu=moments(opt.mu),
                                    nu=moments(opt.nu)),
                "version": np.asarray(self.version, np.int64)}

    def state_dict(self) -> Dict[str, object]:
        """Head parameters + optimizer state as a checkpointable tree.

        The tree is a value, as the reference's immutable arrays are: the
        buffers are copied to host memory (no device memory is spent), so
        later commits, which update the live buffers in place, leave it as
        it was taken.  Pending segmented pushes and older snapshots are
        deliberately excluded: checkpoint between event-loop runs, when
        the server is quiescent."""
        return self._state_tree(lambda x: x.detach().to("cpu", copy=True))

    def state_template(self) -> Dict[str, object]:
        """The :meth:`state_dict` tree with ``meta`` tensors in place of
        the buffers: shapes and dtypes for a checkpoint load, no bytes."""
        return self._state_tree(lambda x: torch.empty_like(x, device="meta"))

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore a :meth:`state_dict` (tensors or numpy arrays), copying
        into the server's own buffers; older snapshots and pending pushes
        are dropped."""
        flats = list(state["flats"])
        _check_flats(flats, self.specs)
        opt = state["opt"]
        for mine, theirs in ((self._opt_state.mu, opt.mu),
                             (self._opt_state.nu, opt.nu)):
            if (mine is None) != (theirs is None):
                raise ValueError("the checkpoint's optimizer moments do not "
                                 "match this server's optimizer")
        with torch.no_grad():
            for dst, src in zip(
                    [*self._flats, *(self._opt_state.mu or ()),
                     *(self._opt_state.nu or ())],
                    [*flats, *(opt.mu or ()), *(opt.nu or ())]):
                dst.copy_(_as_tensor(src))
            self._opt_state.step.fill_(int(np.asarray(opt.step)))
        self.version = int(np.asarray(state["version"]))
        self._snapshots = {}
        self._pending = {}

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def snapshot_versions(self) -> Tuple[int, ...]:
        return tuple(sorted([*self._snapshots, self.version]))

    def flats(self) -> List[torch.Tensor]:
        """The head-version parameter buffers."""
        return list(self._flats)

    def shard_view(self) -> Dict[int, Tuple[int, ...]]:
        """{shard: owned layer ids} under the topology's partition."""
        return {s: self.topology.layers_of_shard(s, self.num_layers)
                for s in range(self.topology.num_servers)}

    def shard_bytes(self) -> Dict[int, int]:
        """Unpadded parameter bytes resident per server shard."""
        return {s: sum(self.specs[l].total * 4 for l in layers)
                for s, layers in self.shard_view().items()}
