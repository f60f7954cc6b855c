"""The port's memoising planner (``repro_torch.core.planner``) against the
reference's (``repro.core.planner``), case for case of
``tests/test_planner.py``.

Both planners get the same ``LayerCosts`` / ``TopologyCosts``, built from
seeded numpy; everything is held exactly: decisions, DP times,
``PlannerStats`` and the ``state_dict()`` JSON (cost keys are the cost
bytes, so equal JSON means the caches hold the same entries in the same
LRU order).  The reference's ``test_warm_solve_equals_fresh_dp`` is not
ported (it fails in the reference): warm solves are held against the
reference's warm solves, through the same ``Planner`` path, never against
a fresh DP.  The HLO retention cases have no counterpart (the port has no
HLO); the plan-step cache is tested in ``tests/test_torch_dynamic.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro import core as ref_core
from repro.core import scheduler as ref_scheduler
from repro_torch import core
from repro_torch.core import scheduler

SEEDS = range(6)


def _mk(lib, pt, fc, bc, gt, dt, dt_bwd=None):
    return lib.LayerCosts(pt=np.array(pt), fc=np.array(fc), bc=np.array(bc),
                          gt=np.array(gt), dt=dt, dt_bwd=dt_bwd)


def _rand(rng, L=None):
    """One random cost point as the arrays both packages take."""
    L = L or int(rng.integers(2, 9))
    return (rng.uniform(0, 10, L), rng.uniform(0, 10, L),
            rng.uniform(0, 10, L), rng.uniform(0, 10, L),
            float(rng.uniform(0, 5)))


def _both(args):
    """(port costs, reference costs) of one cost point."""
    return _mk(core, *args), _mk(ref_core, *args)


def _topo(lib, points):
    return lib.TopologyCosts(workers=tuple(_mk(lib, *p) for p in points))


def _stats(planner):
    return dataclasses.asdict(planner.stats)


def _state_json(planner):
    return json.dumps(planner.state_dict(), sort_keys=True)


def _assert_same(port, ref):
    assert _stats(port) == _stats(ref)
    assert port.stats.hit_rate == ref.stats.hit_rate
    assert len(port) == len(ref)
    assert _state_json(port) == _state_json(ref)


# ---------------------------------------------------------------------------
# memoised planning, port == reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_memoized_equals_reference(seed):
    """decide() equals the reference's decide() (and the reference's
    schedule()) for every strategy; the repeat is a cache hit in both."""
    mine, theirs = _both(_rand(np.random.default_rng(seed)))
    port, ref = core.Planner(), ref_core.Planner()
    for strat in sorted(core.STRATEGIES):
        want = ref.decide(theirs, strat)
        assert want == ref_core.schedule(theirs, strat)
        assert port.decide(mine, strat) == want
        assert port.decide(mine, strat) == ref.decide(theirs, strat)
    assert port.stats.hits == len(core.STRATEGIES)
    _assert_same(port, ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_warm_solve_equals_reference(seed):
    """Only the communication side moves between two cost points: both
    planners warm-start the second solve off the first and agree on the
    decision, the counters and the warm index (prefix sums included)."""
    rng = np.random.default_rng(100 + seed)
    pt, fc, bc, gt, dt = _rand(rng)
    scale, new_dt = float(rng.uniform(0.1, 8.0)), float(rng.uniform(0, 10))
    first = (pt, fc, bc, gt, dt)
    second = (pt * scale, fc, bc, gt * scale, new_dt)
    port, ref = core.Planner(), ref_core.Planner()
    for args in (first, second):
        mine, theirs = _both(args)
        assert port.decide(mine, "dynacomm") == ref.decide(theirs,
                                                           "dynacomm")
    assert port.stats.warm_solves == 1
    _assert_same(port, ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_dp_incumbent_prune_equals_reference(seed):
    """dp_forward / dp_backward with a feasible incumbent and with reused
    prefix sums: the port's segments and times are the reference's."""
    mine, theirs = _both(_rand(np.random.default_rng(200 + seed)))
    L = mine.num_layers
    one = ((1, L),)            # one segment: always feasible, a valid bound
    fc_pref = np.concatenate([[0.0], np.cumsum(mine.fc)])
    bc_pref = np.concatenate([[0.0], np.cumsum(mine.bc[::-1])])
    for kw_f, kw_b in (
            ({"incumbent": core.forward_time(mine, one)},
             {"incumbent": core.backward_time(mine, one)}),
            ({"incumbent": core.dp_forward(mine).time, "fc_pref": fc_pref},
             {"incumbent": core.dp_backward(mine).time,
              "bc_pref": bc_pref})):
        a, b = core.dp_forward(mine, **kw_f), ref_core.dp_forward(theirs,
                                                                  **kw_f)
        assert (a.segments, a.time) == (b.segments, b.time)
        a, b = core.dp_backward(mine, **kw_b), ref_core.dp_backward(theirs,
                                                                    **kw_b)
        assert (a.segments, a.time) == (b.segments, b.time)


def test_homogeneous_fleet_collapses_to_one_solve():
    """W identical workers cost one DP + W-1 dictionary hits in both."""
    point = _rand(np.random.default_rng(7), L=6)
    port, ref = core.Planner(), ref_core.Planner()
    got = port.decide_topology(_topo(core, [point] * 16), "dynacomm")
    want = ref.decide_topology(_topo(ref_core, [point] * 16), "dynacomm")
    assert got == want
    assert port.stats.solves == 1 and port.stats.hits == 15
    _assert_same(port, ref)


def test_consensus_equals_reference_and_caches_topology():
    rng = np.random.default_rng(11)
    points = [_rand(rng, L=5) for _ in range(4)]
    port, ref = core.Planner(), ref_core.Planner()
    want = ref.consensus(_topo(ref_core, points), "dynacomm")
    assert want == ref_core.consensus_decision(_topo(ref_core, points),
                                               "dynacomm")
    assert port.consensus(_topo(core, points), "dynacomm") == want
    # revisit: a whole-topology dictionary hit, no new solves
    assert port.consensus(_topo(core, points), "dynacomm") == \
        ref.consensus(_topo(ref_core, points), "dynacomm")
    assert port.stats.hits == 1
    _assert_same(port, ref)


@pytest.mark.parametrize("cache_size", [1, 2, 3])
def test_lru_eviction_counter_and_bound(cache_size):
    rng = np.random.default_rng(3)
    port = core.Planner(cache_size=cache_size)
    ref = ref_core.Planner(cache_size=cache_size)
    for _ in range(5):
        mine, theirs = _both(_rand(rng, L=4))
        assert port.decide(mine, "sequential") == ref.decide(theirs,
                                                             "sequential")
    assert len(port) <= cache_size
    assert port.stats.evictions == 5 - cache_size
    _assert_same(port, ref)


def test_validation():
    with pytest.raises(ValueError, match="cache_size"):
        core.Planner(cache_size=0)
    mine, _ = _both(_rand(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="strategy"):
        core.Planner().decide(mine, "magic")
    ap = core.AsyncPlanner()
    try:
        with pytest.raises(ValueError, match="strategy"):
            ap.submit(mine, "magic")
    finally:
        ap.close()


def test_clear_drops_entries_but_keeps_counters():
    mine, theirs = _both(_rand(np.random.default_rng(5), L=4))
    port, ref = core.Planner(), ref_core.Planner()
    for planner, c in ((port, mine), (ref, theirs)):
        planner.decide(c, "dynacomm")
        planner.clear()
        assert len(planner) == 0
        planner.decide(c, "dynacomm")          # re-solve, not a hit
    assert port.stats.solves == 2
    _assert_same(port, ref)


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_state_dict_crosses_frameworks(direction):
    """A snapshot written by one package restores into the other, and the
    restored planner serves the same cost points as hits."""
    rng = np.random.default_rng(41)
    points = [_rand(rng, L=6) for _ in range(3)]
    port, ref = core.Planner(), ref_core.Planner()
    for p in points:
        mine, theirs = _both(p)
        port.decide(mine, "dynacomm")
        ref.decide(theirs, "dynacomm")
    src, (dst, lib) = ((ref, (core.Planner(), core))
                       if direction == "reference->port"
                       else (port, (ref_core.Planner(), ref_core)))
    dst.load_state_dict(json.loads(json.dumps(src.state_dict())))
    assert _state_json(dst) == _state_json(src)
    for p in points:
        dst.decide(_mk(lib, *p), "dynacomm")
    assert dst.stats.hits == len(points) and dst.stats.solves == 0


# ---------------------------------------------------------------------------
# async two-phase protocol
# ---------------------------------------------------------------------------


def test_async_submit_collect_equals_reference_sync():
    rng = np.random.default_rng(21)
    points = [_rand(rng, L=6) for _ in range(8)]
    ref = ref_core.Planner()
    want = [ref.decide(_mk(ref_core, *p), "dynacomm") for p in points]
    ap = core.AsyncPlanner()
    try:
        for p in points:
            assert ap.submit(_mk(core, *p), "dynacomm") is True
        ap.drain()
        got = [ap.decide(_mk(core, *p), "dynacomm") for p in points]
    finally:
        ap.close()
    assert got == want
    assert ap.stats.async_submitted == len(points)
    assert ap.stats.sync_fallbacks == 0
    assert ap.stats.hits == len(points)     # drained jobs are cache hits
    assert _state_json(ap) == _state_json(ref)


def test_duplicate_submit_is_refused():
    mine, _ = _both(_rand(np.random.default_rng(23), L=5))
    ap = core.AsyncPlanner()
    try:
        assert ap.submit(mine, "dynacomm") is True
        assert ap.submit(mine, "dynacomm") is False   # in flight or cached
        ap.drain()
        assert ap.submit(mine, "dynacomm") is False   # cached
    finally:
        ap.close()
    assert ap.stats.async_submitted == 1


def test_sync_fallback_without_submit():
    mine, theirs = _both(_rand(np.random.default_rng(29), L=5))
    ap = core.AsyncPlanner()
    try:
        got = ap.decide(mine, "dynacomm")
    finally:
        ap.close()
    assert got == ref_core.schedule(theirs, "dynacomm")
    assert ap.stats.sync_fallbacks == 1
    assert ap.stats.async_submitted == 0


def test_submit_topology_counts_new_jobs():
    rng = np.random.default_rng(31)
    same, other = _rand(rng, L=5), _rand(rng, L=5)
    ap = core.AsyncPlanner()
    try:
        # three identical workers -> one job; the fourth, distinct -> one
        assert ap.submit_topology(_topo(core, [same] * 3 + [other]),
                                  "dynacomm") == 2
        ap.drain()
    finally:
        ap.close()


def test_close_is_idempotent():
    ap = core.AsyncPlanner()
    ap.close()
    ap.close()


# ---------------------------------------------------------------------------
# scheduler restores (the reference's bugfix cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("saved, loaded, match", [
    (dict(cls="topology", strategy="dynacomm", mode="per-worker"),
     dict(cls="topology", strategy="dynacomm", mode="consensus"), "mode"),
    (dict(cls="topology", strategy="lbl"),
     dict(cls="topology", strategy="dynacomm"), "strategy"),
    (dict(cls="dynacomm", strategy="ibatch"),
     dict(cls="dynacomm", strategy="dynacomm"), "strategy"),
])
def test_cross_config_restore_raises(saved, loaded, match):
    def make(cls, **kw):
        return (scheduler.TopologyScheduler(**kw) if cls == "topology"
                else scheduler.DynaCommScheduler(**kw))
    with pytest.raises(ValueError, match=match):
        make(**loaded).load_state_dict(make(**saved).state_dict())


def test_same_mode_roundtrip_equals_reference():
    rng = np.random.default_rng(13)
    points = [_rand(rng, L=4) for _ in range(3)]
    states = []
    for lib, mod in ((core, scheduler), (ref_core, ref_scheduler)):
        a = mod.TopologyScheduler(strategy="dynacomm", mode="per-worker",
                                  reschedule_every=4, clock=_ticker())
        a.decision_for_iteration(_topo(lib, points))
        b = mod.TopologyScheduler(strategy="dynacomm", mode="per-worker",
                                  reschedule_every=4)
        b.load_state_dict(a.state_dict())
        assert b.state_dict() == a.state_dict()
        states.append(b.state_dict())
    assert states[0] == states[1]


def test_legacy_state_without_mode_loads():
    a = scheduler.TopologyScheduler(strategy="dynacomm", mode="consensus")
    state = a.state_dict()
    del state["mode"], state["strategy"]
    b = scheduler.TopologyScheduler(strategy="dynacomm", mode="consensus")
    b.load_state_dict(state)
    assert b._iter_seen == 0


# ---------------------------------------------------------------------------
# injectable clock
# ---------------------------------------------------------------------------


def _ticker():
    t = [0.0]

    def clock():
        t[0] += 0.5
        return t[0]
    return clock


@pytest.mark.parametrize("with_planner", [False, True])
def test_fixed_clock_streams_equal_reference(with_planner):
    rng = np.random.default_rng(17)
    knots = [_rand(rng, L=5) for _ in range(4)]

    def run(lib, mod):
        sched = mod.DynaCommScheduler(
            strategy="dynacomm", reschedule_every=1, clock=_ticker(),
            planner=lib.Planner() if with_planner else None)
        out = []
        for p in knots:
            d = sched.decision_for_iteration(_mk(lib, *p))
            out.append((d, sched.last_scheduling_seconds,
                        sched.scheduling_overhead_hidden(_mk(lib, *p))))
        return out
    mine = run(core, scheduler)
    assert mine == run(core, scheduler) == run(ref_core, ref_scheduler)
    assert [s for _, s, _ in mine] == [0.5] * 4


def test_topology_scheduler_accepts_clock():
    rng = np.random.default_rng(19)
    points = [_rand(rng, L=4) for _ in range(2)]
    sched = scheduler.TopologyScheduler(strategy="dynacomm",
                                        reschedule_every=1, clock=_ticker(),
                                        planner=core.Planner())
    got = sched.decision_for_iteration(_topo(core, points))
    assert sched.last_scheduling_seconds == 0.5
    assert got == ref_core.consensus_decision(_topo(ref_core, points),
                                              "dynacomm")[0]
