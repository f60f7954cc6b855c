"""The elastic fleet of the port (``repro_torch.fleet``: membership, drift,
``FleetTrainer``; the ``fleet-async`` runtime and the launcher's fleet
flags) against the reference's, on the CPU.

* **The pure modules** (``membership.py``, ``drift.py``, copied verbatim
  apart from imports): synthesized schedules event for event over seeds,
  churn rates and fleet floors; ``validate_against`` raising where the
  reference raises; roster projections and state round trips; the drift
  detector's triggers and state over one gap stream.
* **``FleetTrainer``** on the reference's toy layers and loss
  (``tests/test_fleet.py``), from the same numpy draws, in both packages:
  the W = 64 churn run (drift, join, leave, crash, stall), stall
  eviction, a crash mid-push, measured drift, synthesized churn at W = 64
  and int8 pushes with a crash.  Each run's log (every field exact, the
  losses to rtol 1e-6), membership and re-plan events (under one fixed
  ``clock``), ledger with ``migrated_bytes`` / ``num_reshards``, push
  history, plans and roster history equal the reference's; the
  reference's own ledger and membership audits
  (``repro.analysis.conformance``) pass on the port's objects.
* **Re-sharding under AdamW**, **determinism** and a **mid-run resume**
  through ``save_loop_state`` / ``restore_loop_state``, port against port
  bitwise, with the server state taken by ``PSServer.state_dict`` (a value
  since this slice); the loop-state file's keys and meta equal the
  reference's.
* **``fleet_async.json``** through ``build_runtime(..., device="cpu")``
  from the reference's initial server state, and the launcher's fleet
  flags against the reference's ``config_from_flags``.
"""

import argparse
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.conformance import (verify_fleet_membership,
                                        verify_push_ledger)
from repro.fleet import FleetDriftDetector as JaxDetector
from repro.fleet import FleetEvent as JaxEvent
from repro.fleet import FleetMembership as JaxMembership
from repro.fleet import FleetSchedule as JaxSchedule
from repro.fleet import FleetTrainer as JaxFleetTrainer
from repro.fleet import WorkerSpec as JaxSpec
from repro.optim import adamw as jax_adamw
from repro.optim import sgd as jax_sgd
from repro.runtime import RuntimeConfig as JaxRuntimeConfig
from repro.runtime import build_runtime as jax_build_runtime
from repro_torch.fleet import (FleetDriftDetector, FleetEvent,
                               FleetMembership, FleetSchedule, FleetTrainer,
                               WorkerSpec)
from repro_torch.optim import adamw, sgd
from repro_torch.runtime import RuntimeConfig, build_runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "examples", "runtime_configs", "fleet_async.json")
LAYERS, WIDTH = 3, 8
TOY_RTOL = 1e-6             # toy losses (measured on the CPU: <= 2.04e-7)
LOSS_RTOL = 1e-5            # the reduced granite through the runtime
PKG = {
    "port": dict(trainer=FleetTrainer, event=FleetEvent, spec=WorkerSpec,
                 schedule=FleetSchedule, detector=FleetDriftDetector,
                 membership=FleetMembership, sgd=sgd, adamw=adamw),
    "ref": dict(trainer=JaxFleetTrainer, event=JaxEvent, spec=JaxSpec,
                schedule=JaxSchedule, detector=JaxDetector,
                membership=JaxMembership, sgd=jax_sgd, adamw=jax_adamw),
}


def ticker():
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]
    return clock


# ---------------------------------------------------------------------------
# the reference's toy layers, loss and batch, in both packages
# ---------------------------------------------------------------------------


def _toy_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(WIDTH).astype(np.float32)
            for _ in range(LAYERS)]


def _toy_layers(pkg):
    if pkg == "ref":
        return [{"w": jnp.asarray(a)} for a in _toy_arrays()]
    return [{"w": torch.from_numpy(a)} for a in _toy_arrays()]


def _jax_loss(layer_list, batch):
    err = sum(jnp.sum((layer["w"] - batch["target"]) ** 2)
              for layer in layer_list)
    return err / len(layer_list)


def _torch_loss(layer_list, batch):
    err = sum(torch.sum((layer["w"] - batch["target"]) ** 2)
              for layer in layer_list)
    return err / len(layer_list)


def _batch_fn(pkg):
    if pkg == "ref":
        return lambda worker, idx: {"target": jnp.zeros((WIDTH,),
                                                         jnp.float32)}
    return lambda worker, idx: {"target": torch.zeros(WIDTH)}


def _specs(pkg, specs):
    """``{id: (down, up, flops)}`` (or an int) as the package's specs."""
    if isinstance(specs, int):
        return specs
    cls = PKG[pkg]["spec"]
    return {w: cls(*s) for w, s in specs.items()}


def _schedule(pkg, events):
    """``events`` as ``(time, kind, worker, extra)`` tuples."""
    p = PKG[pkg]
    out = []
    for t, kind, w, extra in events:
        extra = dict(extra)
        if "spec" in extra:
            extra["spec"] = p["spec"](*extra["spec"])
        out.append(p["event"](time=t, kind=kind, worker=w, **extra))
    return p["schedule"](tuple(out))


def _make(pkg, workers, *, optimizer=("sgd", 1e-2), events=(),
          schedule=None, detector=None, compressor=None, **kw):
    p = PKG[pkg]
    name, lr = optimizer
    opt = p[name](lr, 0.0) if name == "sgd" else p[name](lr)
    if detector is not None:
        kw["drift_detector"] = p["detector"](**detector)
    if compressor is not None:
        kw["compressor"] = _compressor(pkg, compressor)
    tr = p["trainer"](
        init_layers=_toy_layers(pkg),
        loss_fn=_jax_loss if pkg == "ref" else _torch_loss,
        optimizer=opt, workers=_specs(pkg, workers),
        schedule=schedule(pkg) if schedule else _schedule(pkg, events),
        throttle="wait", **kw)
    tr.scheduler.clock = ticker()
    return tr


def _compressor(pkg, scheme):
    if pkg == "ref":
        from repro.compress import make_compressor
    else:
        from repro_torch.compress import make_compressor
    return make_compressor(scheme)


def _drift_profiles(pkg):
    """The reference's compute-dominated profiles of the drift test."""
    if pkg == "ref":
        from repro.dist.collectives import make_flat_spec
        from repro.ps.dynamic import profiles_from_specs
    else:
        from repro_torch.dist.collectives import make_flat_spec
        from repro_torch.ps.dynamic import profiles_from_specs
    return profiles_from_specs([make_flat_spec(t, 1)
                                for t in _toy_layers(pkg)],
                               flops_per_param=1e4)


def _synth(pkg, W=64):
    return PKG[pkg]["schedule"].synthesize(range(W), churn=20.0,
                                           horizon=0.8, seed=7)


SCENARIOS = {
    # the reference's TestFleetChurn.test_w64_churn_run
    "churn64": dict(pushes=160, workers=64, num_servers=2,
                    workers_per_shard=16, staleness=2, events=(
                        (0.05, "drift", 4, {"factor": 2.0}),
                        (0.10, "join", 64, {"spec": (10e9, 0.5e9, 1e10)}),
                        (0.20, "leave", 1, {}),
                        (0.30, "fail", 2, {"mode": "crash"}),
                        (0.35, "fail", 3, {"mode": "stall"}))),
    "stall": dict(pushes=40, workers=4, num_servers=1, staleness=1,
                  stall_factor=2.0,
                  events=((0.05, "fail", 0, {"mode": "stall"}),)),
    "crash": dict(pushes=30, workers=2, num_servers=1, staleness=1,
                  events=((0.06, "fail", 0, {"mode": "crash"}),)),
    "drift": dict(pushes=80, workers={w: (100e9, 100e9, 1e7)
                                      for w in range(3)},
                  num_servers=1, staleness=2,
                  detector=dict(threshold=0.3, patience=2, warmup=2),
                  events=((0.2, "drift", 0, {"factor": 3.0}),)),
    # synthesized churn (the reference's 512-worker class, at W = 64)
    "synth64": dict(pushes=120, workers=64, num_servers=4,
                    workers_per_shard=16, staleness=4, schedule=_synth),
    # int8 pushes with error feedback on a two-segment push plan (an
    # iteration is T = 0.0998 s): a join, a crash in flight (a partial
    # walk of one segment), a leave that re-shards from 2 servers to 1
    "int8_crash": dict(pushes=30, workers={w: (10e9, 1e6, 1e7)
                                           for w in range(3)},
                       num_servers=2, workers_per_shard=2, staleness=1,
                       compressor="int8", optimizer=("adamw", 1e-2),
                       events=((0.15, "join", 3,
                                {"spec": (10e9, 1e6, 1e7)}),
                               (0.25, "fail", 1, {"mode": "crash"}),
                               (0.35, "leave", 2, {}))),
}


def _build(pkg, name):
    kw = dict(SCENARIOS[name])
    pushes = kw.pop("pushes")
    if name in ("drift", "int8_crash"):
        kw["profiles"] = _drift_profiles(pkg)
    return _make(pkg, kw.pop("workers"), **kw), pushes


def _log_key(log):
    """The run log without its losses, every other field exact."""
    return [(e.worker, e.sim_time, e.version, e.retries, e.wait_s,
             e.result.worker, e.result.accepted, e.result.staleness,
             e.result.version) for e in log.events]


def _plan(p):
    return p.forward, p.backward


def _summary(tr, log):
    """Everything but the losses, as package-free values."""
    return dict(
        log=_log_key(log),
        membership_events=[dataclasses.asdict(e)
                           for e in tr.membership_events],
        replan_events=[dataclasses.asdict(e) for e in tr.replan_events],
        ledger=dataclasses.asdict(tr.server.ledger),
        push_history={w: tuple((_plan(p), full, extra)
                               for p, full, extra in hist)
                      for w, hist in tr.push_history.items()},
        plans={w: _plan(p) for w, p in tr.plans.items()},
        joined_at=tr.membership.joined_at,
        departed=tr.membership.departed,
        num_servers=tr.server.topology.num_servers,
        residual_keys=sorted(tr._residuals),
        believed=tr._believed)


@pytest.fixture(scope="module")
def runs():
    """Every scenario once in each package."""
    out = {}
    for name in SCENARIOS:
        for pkg in ("ref", "port"):
            tr, pushes = _build(pkg, name)
            log = tr.run(pushes, _batch_fn(pkg))
            out[name, pkg] = dict(tr=tr, log=log, losses=log.losses,
                                  summary=_summary(tr, log))
    return out


# ---------------------------------------------------------------------------
# the pure modules
# ---------------------------------------------------------------------------


def _events(schedule):
    return [e.to_dict() for e in schedule.events]


@pytest.mark.parametrize("seed,churn,min_fleet", [
    (0, 2.0, None), (11, 2.0, None), (12, 6.0, 2), (7, 20.0, 1),
    (3, 40.0, 8)])
def test_synthesized_schedules_equal_the_reference(seed, churn, min_fleet):
    kw = dict(churn=churn, horizon=5.0, seed=seed, min_fleet=min_fleet)
    mine = FleetSchedule.synthesize(range(16), **kw)
    ref = JaxSchedule.synthesize(range(16), **kw)
    assert _events(mine) == _events(ref) and len(mine) > 0
    mine.validate_against(range(16))


@pytest.mark.parametrize("events,initial,match", [
    (((1.0, "join", 2, {}),), (0, 1, 2, 3), "already used"),
    (((1.0, "fail", 9, {}),), (0, 1), "not active"),
    (((1.0, "leave", 1, {}), (2.0, "drift", 1, {"factor": 2.0})), (0, 1),
     "not active"),
    (((1.0, "join", 4, {}), (2.0, "leave", 4, {})), (0, 1, 2, 3), None),
])
def test_validate_against_raises_where_the_reference_raises(events, initial,
                                                            match):
    for pkg in ("ref", "port"):
        sched = _schedule(pkg, events)
        if match is None:
            sched.validate_against(initial)
            continue
        with pytest.raises(ValueError, match=match):
            sched.validate_against(initial)
    with pytest.raises(ValueError, match="ordered by time"):
        _schedule("port", ((2.0, "leave", 0, {}), (1.0, "leave", 1, {})))
    for bad, match in ((dict(kind="nope"), "kind"),
                       (dict(kind="fail", mode="explode"), "fail mode"),
                       (dict(kind="leave", spec=WorkerSpec()), "only join")):
        with pytest.raises(ValueError, match=match):
            FleetEvent(time=0.0, worker=0, **bad)


def test_membership_projection_and_state_equal_the_reference():
    out = {}
    for pkg in ("ref", "port"):
        p = PKG[pkg]
        m = p["membership"]({0: p["spec"](), 2: p["spec"](up_bps=2e9)})
        m.join(5, p["spec"](flops=5e9), time=1.0, version=3)
        m.depart(0, time=2.0, reason="crash")
        with pytest.raises(ValueError, match="already used"):
            m.join(0, p["spec"](), time=3.0, version=0)
        topo = m.topology(2, flops_scale={5: 2.0})
        r = p["membership"].from_state(m.state_dict())
        assert (r.active, r.joined_at, r.departed) == \
            (m.active, m.joined_at, m.departed)
        out[pkg] = (m.active, m.index_of(5), m.state_dict(),
                    [(l.down.bandwidth_bps, l.up.bandwidth_bps,
                      l.down.rtt_s, l.up.setup_s) for l in topo.links],
                    topo.worker_flops, topo.num_servers)
    assert out["port"] == out["ref"]


def test_drift_detector_equals_the_reference_over_one_gap_stream():
    rng = np.random.default_rng(3)
    gaps = [(int(w), float(g)) for w, g in zip(
        rng.integers(0, 3, 200), np.abs(rng.normal(1.0, 0.4, 200)) + 0.05)]
    gaps += [(0, 4.0)] * 8 + [(1, 0.2)] * 8
    states = {}
    for pkg in ("ref", "port"):
        det = PKG[pkg]["detector"](threshold=0.3, patience=2, warmup=2)
        fired = [det.observe(w, g) for w, g in gaps]
        det.forget(2)
        states[pkg] = (fired, det.state_dict(), det.observed_gap(0))
        restored = PKG[pkg]["detector"]()
        restored.load_state_dict(det.state_dict())
        assert restored.state_dict() == det.state_dict()
    assert states["port"] == states["ref"] and any(states["port"][0])
    with pytest.raises(ValueError, match="alpha"):
        FleetDriftDetector(alpha=0.0)
    with pytest.raises(ValueError, match="positive"):
        FleetDriftDetector().observe(0, 0.0)


# ---------------------------------------------------------------------------
# FleetTrainer against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_run_equals_the_reference(name, runs):
    mine, ref = runs[name, "port"], runs[name, "ref"]
    assert mine["summary"] == ref["summary"]
    np.testing.assert_allclose(mine["losses"], ref["losses"], rtol=TOY_RTOL)
    assert len(mine["log"].accepted) == SCENARIOS[name]["pushes"]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_references_audits_pass_on_the_port(name, runs):
    """The reference's ledger and membership audits on the port's run:
    pushed bytes decompose under each worker's push history (a crash's
    partial walk included), joins anchor pushes, the bound holds."""
    tr, log = runs[name, "port"]["tr"], runs[name, "port"]["log"]
    k = SCENARIOS[name]["staleness"]
    assert log.max_staleness <= k
    assert verify_push_ledger(tr.server.ledger, tr.push_history, tr.specs,
                              tr.compressor) == []
    assert verify_fleet_membership(log, tr.membership.joined_at,
                                   tr.membership.departed,
                                   staleness_bound=k) == []


def test_churn_run_replans_at_every_membership_event(runs):
    tr = runs["churn64", "port"]["tr"]
    kinds = [e.kind for e in tr.membership_events]
    assert {"join", "leave", "crash", "stall"} <= set(kinds)
    by_reason = {e.reason: e for e in tr.replan_events}
    assert [e.reason for e in tr.replan_events][0] == "init"
    assert by_reason["join"].sim_time == pytest.approx(0.10)
    assert by_reason["join"].num_workers == 65
    assert 64 in tr.plans and 1 not in tr.plans and 2 not in tr.plans
    assert tr.server.topology.num_servers == 4
    assert any(e.resharded for e in tr.replan_events)
    assert tr.membership.departed[2][1] == "crash"
    assert all(k[0] != 2 for k in tr.server._pending)


def test_stall_crash_and_drift_behave_as_the_reference_asserts(runs):
    stall = runs["stall", "port"]["tr"]
    assert "stall-evict" in [e.kind for e in stall.membership_events]
    assert stall.membership.departed[0][1] == "stall"
    crash = runs["crash", "port"]["tr"]
    assert not crash.membership.is_active(0)
    assert all(k[0] != 0 for k in crash.server._pending)
    drift = runs["drift", "port"]["tr"]
    replans = [e for e in drift.replan_events if e.reason == "drift"]
    assert replans and replans[0].worker == 0
    assert 1.3 <= drift._believed[0] <= 3.5
    assert drift._believed == runs["drift", "ref"]["tr"]._believed


def test_int8_crash_accounts_the_wire_and_drops_the_residuals(runs):
    """Wire bytes and the push ratio equal the reference's, the crashed
    and the departed workers' residuals are gone, and the crashed worker
    walked one segment of its last push.  The toy losses are compared over
    all 30 pushes (``test_fleet_run_equals_the_reference``): on these
    8-wide layers no roundoff gradient difference moved a tile's int8
    scale (measured on the CPU: 1.16e-7 at most, against 1.4e-6 for the
    CNN's first 6 pushes in ``test_torch_async_ps.py``)."""
    mine, ref = runs["int8_crash", "port"], runs["int8_crash", "ref"]
    tr = mine["tr"]
    led = tr.server.ledger
    assert led.pushed_wire_bytes == ref["tr"].server.ledger.pushed_wire_bytes
    assert led.compression_ratio("push") == \
        ref["tr"].server.ledger.compression_ratio("push") > 1
    assert {w for w, _ in tr._residuals} == set(tr.membership.active)
    assert tr.push_history[1][-1][2] >= 1          # the crash's partial walk
    assert led.num_reshards == 1


def test_fleet_exhaustion_raises_and_the_constructor_validates():
    for pkg in ("ref", "port"):
        tr = _make(pkg, 2, num_servers=1, staleness=1,
                   events=((0.01, "leave", 0, {}), (0.02, "leave", 1, {})))
        with pytest.raises(RuntimeError, match="fleet"):
            tr.run(500, _batch_fn(pkg))
    with pytest.raises(ValueError, match="throttle"):
        FleetTrainer(init_layers=_toy_layers("port"), loss_fn=_torch_loss,
                     optimizer=sgd(1e-2), workers=2, throttle="nope")
    with pytest.raises(ValueError, match="stall_factor"):
        _make("port", 2, stall_factor=1.0)
    with pytest.raises(ValueError, match="not active"):
        _make("port", 2, events=((0.1, "leave", 9, {}),))
    with pytest.raises(ValueError, match="workers_per_shard"):
        _make("port", 2, workers_per_shard=-1)


# ---------------------------------------------------------------------------
# re-sharding under AdamW (the reference's TestReshard)
# ---------------------------------------------------------------------------


def _trained(pkg, optimizer):
    tr = _make(pkg, 6, num_servers=2, staleness=2, optimizer=optimizer)
    tr.run(12, _batch_fn(pkg))
    return tr


def test_reshard_keeps_the_versioned_state_bitwise():
    tr = _trained("port", ("adamw", 1e-3))
    server = tr.server
    before = [[f.clone() for f in fs] for fs in (
        server.flats(), server._opt_state.mu, server._opt_state.nu)]
    version = server.version
    info = server.reshard(tr.membership.topology(3))
    assert info["num_servers"] == 3 and server.version == version
    for old, new in zip(before, (server.flats(), server._opt_state.mu,
                                 server._opt_state.nu)):
        assert all(torch.equal(a, b) for a, b in zip(old, new))


@pytest.mark.parametrize("optimizer,slots", [(("sgd", 1e-2), 0),
                                             (("adamw", 1e-3), 2)])
def test_migration_bytes_follow_the_formula_as_the_reference(optimizer,
                                                             slots):
    infos = {}
    for pkg in ("ref", "port"):
        tr = _trained(pkg, optimizer)
        server = tr.server
        old, new = server.topology, tr.membership.topology(3)
        L = server.num_layers
        moved = [l for l in range(L)
                 if old.shard_of_layer(l, L) != new.shard_of_layer(l, L)]
        want = sum(server.specs[l].total * 4 for l in moved) * (1 + slots)
        info = server.reshard(new)
        assert info["moved_layers"] == len(moved)
        assert info["migrated_bytes"] == server.ledger.migrated_bytes == want
        assert server.ledger.num_reshards == 1
        infos[pkg] = info
    assert infos["port"] == infos["ref"]


def test_pinned_pull_after_a_reshard_equals_the_pull_before():
    tr = _trained("port", ("adamw", 1e-3))
    server = tr.server
    bucket = tuple(range(server.num_layers))
    for pin in server.snapshot_versions:
        pre = {l: f.clone() for l, f in
               server.pull_bucket(bucket, version=pin)[1].items()}
        server.reshard(tr.membership.topology(3 if pin % 2 else 1))
        post = server.pull_bucket(bucket, version=pin)[1]
        assert all(torch.equal(pre[l], post[l]) for l in bucket)


# ---------------------------------------------------------------------------
# determinism and a mid-run resume (synthesized churn at W = 64)
# ---------------------------------------------------------------------------


def _stripped(tr):
    """Re-plan events without the wall-clock fields."""
    return [(e.sim_time, e.at_push, e.reason, e.worker, e.num_workers,
             e.num_servers, e.plan_changed, e.resharded, e.migrated_bytes)
            for e in tr.replan_events]


def _full_key(log):
    return [(*k, e.loss) for k, e in zip(_log_key(log), log.events)]


def test_two_port_runs_are_bit_identical(runs):
    tr, pushes = _build("port", "synth64")
    log = tr.run(pushes, _batch_fn("port"))
    first = runs["synth64", "port"]
    assert _full_key(log) == _full_key(first["log"])
    assert tr.membership_events == first["tr"].membership_events
    assert _stripped(tr) == _stripped(first["tr"])
    assert all(torch.equal(a, b) for a, b in
               zip(tr.server.flats(), first["tr"].server.flats()))


def test_resume_mid_run_is_bitwise_the_uninterrupted_run(runs, tmp_path):
    full = runs["synth64", "port"]
    pushes = SCENARIOS["synth64"]["pushes"]
    half = pushes // 2
    first, _ = _build("port", "synth64")
    fn = _batch_fn("port")
    first.run(half, fn)
    server_state = first.server.state_dict()
    path = str(tmp_path / "loop.npz")
    first.save_loop_state(path)
    log_first = first.run(pushes - half, fn, reset=False)
    resumed, _ = _build("port", "synth64")
    resumed.server.load_state_dict(server_state)
    resumed.restore_loop_state(path)
    log_resumed = resumed.run(pushes - half, fn, reset=False)
    assert _full_key(log_resumed) == _full_key(log_first) == \
        _full_key(full["log"])
    assert resumed.membership_events == first.membership_events == \
        full["tr"].membership_events
    assert _stripped(resumed) == _stripped(full["tr"])
    assert dataclasses.asdict(resumed.server.ledger) == \
        dataclasses.asdict(full["tr"].server.ledger)
    assert all(torch.equal(a, b) for a, b in
               zip(resumed.server.flats(), full["tr"].server.flats()))


def _loop_file(tr, path):
    tr.save_loop_state(path)
    with np.load(path) as f:
        return {k: np.array(f[k]) for k in f.files}


def _meta_without_losses(meta):
    losses = [row[3] for row in meta["log"]] + \
        [row[4] for row in meta["in_flight"]] + \
        [row[3] for row in meta["barrier"]]
    for row in meta["log"] + meta["barrier"]:
        row[3] = None
    for row in meta["in_flight"]:
        row[4] = None
    return meta, losses


@pytest.mark.parametrize("name", ["synth64", "int8_crash"])
def test_loop_state_file_has_the_references_keys_and_meta(name, runs,
                                                          tmp_path):
    files = {pkg: _loop_file(runs[name, pkg]["tr"],
                             str(tmp_path / f"{pkg}.loop"))
             for pkg in ("ref", "port")}
    assert sorted(files["port"]) == sorted(files["ref"])
    metas = {pkg: _meta_without_losses(json.loads(str(f["meta"])))
             for pkg, f in files.items()}
    assert metas["port"][0] == metas["ref"][0]
    np.testing.assert_allclose(metas["port"][1], metas["ref"][1],
                               rtol=TOY_RTOL)
    for key in files["port"]:
        if key != "meta":
            np.testing.assert_allclose(files["port"][key],
                                       files["ref"][key], rtol=TOY_RTOL,
                                       atol=1e-7, err_msg=key)


# ---------------------------------------------------------------------------
# the runtime and the launcher
# ---------------------------------------------------------------------------


PUSHES = 6


@pytest.fixture(scope="module")
def config_runs(tmp_path_factory):
    """``fleet_async.json`` in both packages, the port from the
    reference's initial server state, and a port run restored from the
    port's mid-run checkpoint."""
    tmp = tmp_path_factory.mktemp("fleet_async")
    ref = jax_build_runtime(JaxRuntimeConfig.load(CONFIG))
    rt = build_runtime(RuntimeConfig.load(CONFIG), device="cpu")
    state = ref.trainer.server.state_dict()
    opt = state["opt"]
    rt.trainer.server.load_state_dict(dict(
        state, flats=[np.array(f) for f in state["flats"]],
        opt=opt._replace(mu=[np.array(m) for m in opt.mu],
                         nu=[np.array(m) for m in opt.nu])))
    for r in (ref, rt):
        r.trainer.scheduler.clock = ticker()
    out = dict(ref_losses=ref.fit(PUSHES), losses=rt.fit(3))
    mid = str(tmp / "mid.npz")
    rt.save_state(mid)
    out["losses"] += rt.fit(PUSHES - 3)
    resumed = build_runtime(RuntimeConfig.load(CONFIG), device="cpu")
    resumed.restore_state(mid)
    out["resumed"] = resumed.fit(PUSHES - 3)
    out["resumed_log"] = _log_key(resumed.timeline())
    for pkg, r in (("ref", ref), ("port", rt)):
        path = str(tmp / f"{pkg}.npz")
        r.save_state(path)
        with np.load(path) as f, np.load(path + ".loop") as g:
            keys = (sorted(f.files), sorted(g.files))
        out[pkg] = dict(
            events=[(type(e).__name__, dataclasses.asdict(e))
                    for e in r.events],
            ledger=r.ledger, keys=keys, log=_log_key(r.timeline()),
            history={w: tuple((_plan(p), n, x) for p, n, x in h)
                     for w, h in r.trainer.push_history.items()},
            stats=r.trainer.planner_stats)
    return out


def test_fleet_config_equals_the_reference(config_runs):
    mine, ref = config_runs["port"], config_runs["ref"]
    assert mine == ref
    assert [k for k, _ in mine["events"]].count("MembershipChange") == 2
    np.testing.assert_allclose(config_runs["losses"],
                               config_runs["ref_losses"], rtol=LOSS_RTOL)
    assert "server/flats/0" in mine["keys"][0] and "meta" in mine["keys"][1]


def test_fleet_runtime_resumes_mid_simulation(config_runs):
    assert config_runs["resumed"] == config_runs["losses"][3:]
    assert config_runs["resumed_log"] == config_runs["port"]["log"]


def _ref_args(**kw):
    args = dict(
        runtime="fleet-async", staleness=1, throttle="wait",
        aggregate=False, ps_workers=3, ps_servers=2, down_gbps=10.0,
        up_gbps=1.0, up_shift_gbps=None, worker_flops=1e10, shift_epoch=1,
        fleet_schedule=None, workers_per_shard=2, arch="granite-3-2b",
        reduced=True, batch=2, seq=16, optimizer="adamw", lr=3e-4,
        strategy="dynacomm", steps_per_epoch=20, drift_detect=False,
        async_planning=True, plan_cache_size=256, bw_gbps=10.0,
        bw_shift_gbps=None, cost_source="analytic", compress="none",
        topk_fraction=0.01, no_error_feedback=False)
    args.update(kw)
    return argparse.Namespace(**args)


def test_launcher_maps_the_fleet_flags_as_the_reference(capsys, tmp_path):
    from repro.launch.train import config_from_flags as jax_from_flags
    from repro_torch.launch.train import main
    sched = tmp_path / "events.json"
    sched.write_text(json.dumps([
        {"time": 0.01, "kind": "join", "worker": 3},
        {"time": 0.03, "kind": "fail", "worker": 1, "mode": "crash"}]))
    argv = ["--runtime", "fleet-async", "--reduced", "--staleness", "1",
            "--throttle", "wait", "--ps-workers", "3", "--batch", "2",
            "--seq", "16", "--fleet-schedule", str(sched),
            "--workers-per-shard", "2", "--async-planning"]
    main(argv + ["--dump-config"])
    mine = json.loads(capsys.readouterr().out)
    assert mine == json.loads(jax_from_flags(_ref_args(
        fleet_schedule=str(sched))).to_json())
    assert mine == json.loads(RuntimeConfig.load(CONFIG).to_json())
    with pytest.raises(SystemExit, match="fleet-async"):
        main(["--runtime", "ps", "--staleness", "1", "--fleet-schedule",
              str(sched), "--dump-config"])
    losses = main(argv + ["--steps", "2", "--log-every", "0", "--device",
                          "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "fleet events 2" in out and "re-plan (crash, worker 1)" in out
    assert "crash worker 1 (fleet size 3)" in out
