"""The port's fault-tolerance stack (``repro_torch.ft.resilience`` and
``ft.chaos``) against the JAX package's: the heartbeat monitor, the
straggler mitigator, the restart policy, ``plan_rescale`` at every host
count from 1 to 8, the survivor mesh over logical ids, and the chaos
schedule and fault injector, each fed the same inputs and giving the same
outputs.  Twins of ``tests/test_ft.py``'s and ``tests/test_chaos.py``'s
unit cases run on the port's classes."""
import dataclasses

import jax
import numpy as np
import pytest

from repro import ft as J
from repro.ft import chaos as jchaos
from repro_torch import ft as T
from repro_torch.ft import chaos as tchaos
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# HeartbeatMonitor, StragglerMitigator, RestartPolicy: same inputs, outputs
# ---------------------------------------------------------------------------

def test_heartbeat_timeout_boundary_is_strict():
    clock = FakeClock()
    mon = T.HeartbeatMonitor(n_hosts=2, timeout_s=10.0, clock=clock)
    mon.beat(0, step=1)
    mon.beat(1, step=1)
    clock.t = 10.0
    assert mon.dead_hosts() == [] and mon.healthy()
    clock.t = 10.0 + 1e-9
    assert mon.dead_hosts() == [0, 1] and not mon.healthy()


def test_heartbeat_explicit_host_ids_and_spelling():
    clock = FakeClock()
    mon = T.HeartbeatMonitor(hosts={1, 3}, timeout_s=5.0, clock=clock)
    assert sorted(mon.hosts) == [1, 3]
    clock.t = 6.0
    assert mon.dead_hosts() == [1, 3]
    with pytest.raises(AssertionError):
        T.HeartbeatMonitor(n_hosts=2, hosts={0, 1})
    with pytest.raises(AssertionError):
        T.HeartbeatMonitor()


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_monitor_matches_jax(seed):
    """A random stream of clock moves and beats (with step times) through
    both monitors: the same dead hosts, health and EWMAs after each."""
    rng = np.random.default_rng(seed)
    cj, ct = FakeClock(), FakeClock()
    mj = J.HeartbeatMonitor(n_hosts=4, timeout_s=3.0, clock=cj)
    mt = T.HeartbeatMonitor(n_hosts=4, timeout_s=3.0, clock=ct)
    for i in range(60):
        dt = float(rng.choice([0.0, 0.5, 1.0, 3.0, 4.0]))
        cj.t += dt
        ct.t += dt
        for h in range(4):
            if rng.random() < 0.6:
                s = float(rng.uniform(0.5, 3.0))
                mj.beat(h, i, s)
                mt.beat(h, i, s)
        assert mt.dead_hosts() == mj.dead_hosts()
        assert mt.healthy() == mj.healthy()
        assert [mt.hosts[h].ewma_step_s for h in range(4)] == \
            [mj.hosts[h].ewma_step_s for h in range(4)]


def test_straggler_threshold_times_patience_interplay():
    s = T.StragglerMitigator(threshold=1.5, patience=3)
    slow = {0: 1.0, 1: 1.0, 2: 1.0, 3: 2.0}
    fast = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    got = [s.update(x) for x in (slow, slow, fast, slow, slow, slow, slow)]
    assert got == [[], [], [], [], [], [3], [3]]


@pytest.mark.parametrize("seed", range(4))
def test_straggler_mitigator_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sj = J.StragglerMitigator(threshold=1.5, patience=2)
    st = T.StragglerMitigator(threshold=1.5, patience=2)
    for _ in range(40):
        n = int(rng.integers(1, 7))
        ewma = {h: float(rng.choice([0.0, 1.0, 1.2, 2.0, 5.0])) for h in range(n)}
        assert st.update(ewma) == sj.update(ewma)


@pytest.mark.parametrize("kw", [dict(max_restarts=12, backoff_s=5.0),
                                dict(max_restarts=2, backoff_s=1.0),
                                dict(max_restarts=10, backoff_s=0.5,
                                     max_backoff_s=10.0),
                                dict(max_restarts=0, backoff_s=1.0)],
                         ids=["default-cap", "small", "custom-cap", "zero"])
def test_restart_policy_matches_jax(kw):
    pj, pt = J.RestartPolicy(**kw), T.RestartPolicy(**kw)
    for _ in range(14):
        assert pt.should_restart() == pj.should_restart()
        assert pt.next_delay() == pj.next_delay()
        assert pt.restarts == pj.restarts
    pj.restarts = pt.restarts = 5000            # past float overflow
    assert pt.next_delay() == pj.next_delay()


# ---------------------------------------------------------------------------
# plan_rescale and the survivor mesh
# ---------------------------------------------------------------------------

def _plan(mod, *args):
    try:
        return dataclasses.asdict(mod.plan_rescale(*args, restore_step=7))
    except mod.RescaleError as e:
        return ("RescaleError", str(e))


@pytest.mark.parametrize("n_hosts", range(1, 9))
def test_plan_rescale_matches_jax(n_hosts):
    """Every lost-host count on 1 to 8 hosts of 1, 2 or 4 devices, both
    model axes and a few batches: the same plan, or the same refusal."""
    for dph in (1, 2, 4):
        old = n_hosts * dph
        for model in {1, 2 if old % 2 == 0 else 1, old}:
            for gb in (8, 24, 7):
                for lost in range(0, n_hosts + 1):
                    args = (old, lost, dph, (old // model, model), gb)
                    assert _plan(T, *args) == _plan(J, *args), args


def test_survivor_devices_drops_whole_host_blocks():
    ids = range(8)
    assert T.survivor_devices([0], 4, ids) == [4, 5, 6, 7]
    assert T.survivor_devices([1], 2, ids) == [0, 1, 4, 5, 6, 7]
    assert T.survivor_devices([0, 3], 2, ids) == [2, 3, 4, 5]
    assert T.survivor_devices([], 4, ids) == list(ids)
    for lost in ([0], [1], [0, 3], []):
        assert T.survivor_devices(lost, 2, ids) == J.survivor_devices(lost, 2, ids)


@pytest.mark.parametrize("lost", [[0], [1]])
def test_rescale_rules_gives_the_jax_survivor_mesh(lost):
    """The survivor mesh's shape, names and device ids (logical ids, the
    global ranks on a process mesh, here; ``jax.devices()`` ids there) and
    the rules re-derived on it are the reference's, with and without
    extra rule options."""
    plan_args = dict(old_devices=8, lost_hosts=1, devices_per_host=4,
                     mesh_axes=(4, 2), global_batch=8, restore_step=4)
    for kw in (dict(), dict(kv_heads=2), dict(batch=3, act_seq=True)):
        mesh, jrules = J.rescale_rules(J.plan_rescale(**plan_args), lost, 4, **kw)
        got, rules = T.rescale_rules(T.plan_rescale(**plan_args), lost, 4, range(8),
                                     **kw)
        assert got.sizes == tuple(mesh.devices.shape)
        assert got.axis_names == tuple(mesh.axis_names)
        assert list(got.ranks) == [d.id for d in mesh.devices.flat]
        assert rules.rules == jrules.rules, kw
        assert rules.mesh is got and got.transport is None   # abstract: no group
    assert jax.device_count() == 8


def test_rescale_rules_insufficient_survivors():
    plan = T.plan_rescale(old_devices=8, lost_hosts=1, devices_per_host=4,
                          mesh_axes=(4, 2), global_batch=8, restore_step=0)
    with pytest.raises(T.RescaleError, match="survived"):
        T.rescale_rules(plan, [0, 1], 4, range(8))


# ---------------------------------------------------------------------------
# chaos schedule, virtual clock, fault injector
# ---------------------------------------------------------------------------

SPECS = ["kill@5:h0,straggle@1:h1:x2.5:d2,ckpt_crash@5", "", " kill@2:h1 , ",
         "straggle@0:h3:x3:d50", "kill@2:h0,kill@3:h1,ckpt_crash@1",
         "straggle@1:h1:x3:d2,kill@4:h2"]


def _events(sched):
    return [dataclasses.astuple(e) for e in sched.events]


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_parse_and_to_spec_match_jax(spec):
    got, want = tchaos.ChaosSchedule.parse(spec), jchaos.ChaosSchedule.parse(spec)
    assert _events(got) == _events(want)
    assert got.to_spec() == want.to_spec()
    assert tchaos.ChaosSchedule.parse(got.to_spec()) == got
    for s in range(8):
        assert [dataclasses.astuple(e) for e in got.events_at(s)] == \
            [dataclasses.astuple(e) for e in want.events_at(s)]


@pytest.mark.parametrize("bad", ["explode@3:h0", "kill@3", "kill@3:h0:q9"])
def test_schedule_parse_errors_match_jax(bad):
    with pytest.raises(ValueError) as want:
        jchaos.ChaosSchedule.parse(bad)
    with pytest.raises(ValueError) as got:
        tchaos.ChaosSchedule.parse(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(12))
def test_schedule_from_seed_matches_jax(seed):
    for kw in (dict(steps=12, n_hosts=4, n_kills=2, n_straggles=2,
                    n_ckpt_crashes=1),
               dict(steps=12, n_hosts=2, n_kills=5),
               dict(steps=30, n_hosts=8, n_kills=3, n_straggles=0,
                    n_ckpt_crashes=2, straggle_factor=4.0)):
        got = tchaos.ChaosSchedule.from_seed(seed, **kw)
        want = jchaos.ChaosSchedule.from_seed(seed, **kw)
        assert got.to_spec() == want.to_spec()
        assert _events(got) == _events(want)


def test_virtual_clock():
    c = tchaos.VirtualClock()
    assert c() == 0.0
    assert c.advance(2.5) == 2.5
    with pytest.raises(AssertionError):
        c.advance(-1.0)


@pytest.mark.parametrize("spec, n_hosts, kw", [
    ("kill@2:h0", 2, {}),
    ("straggle@1:h1:x3:d2", 2, dict(timeout_s=10.0)),
    ("straggle@0:h3:x3:d50", 4, dict(timeout_s=1e9)),
    ("kill@1:h0,straggle@2:h2:x2.5:d3,ckpt_crash@4", 4, {}),
    ("straggle@1:h1:x2.5:d2,ckpt_crash@6,kill@5:h0", 2, {}),
])
def test_fault_injector_statuses_match_jax(spec, n_hosts, kw):
    """12 ticks of the same schedule: the same statuses, clock, alive and
    failed sets; an eviction at the first loss starts the same epoch."""
    ij = jchaos.FaultInjector(jchaos.ChaosSchedule.parse(spec), n_hosts, **kw)
    it = tchaos.FaultInjector(tchaos.ChaosSchedule.parse(spec), n_hosts, **kw)
    evicted = False
    for step in range(12):
        sj, st = ij.tick(step), it.tick(step)
        assert dataclasses.asdict(st) == dataclasses.asdict(sj)
        assert st.lost == sj.lost
        assert it.clock() == ij.clock()
        assert (it.alive, it.failed) == (ij.alive, ij.failed)
        if st.lost and not evicted:
            ij.evict(sj.lost)
            it.evict(st.lost)
            evicted = True
            assert sorted(it.monitor.hosts) == sorted(ij.monitor.hosts)


def test_injector_kill_detection_latency():
    inj = tchaos.FaultInjector(tchaos.ChaosSchedule.parse("kill@2:h0"),
                               n_hosts=2, timeout_s=3.5, base_step_s=1.0)
    detected_at = next(s for s in range(8) if inj.tick(s).dead)
    assert detected_at == 5
    assert inj.failed == {0} and 0 not in inj.alive
