"""Deterministic fault injection for the chaos-tested elastic trainer.

The port's counterpart of ``repro.ft.chaos`` (pure Python and numpy, a
twin, since the port may not import the reference).

AraXL's physical-scalability claim has a software twin: the training job
must keep working as hosts die and straggle, the way the machine keeps
working as lanes and clusters multiply.  This module is the *adversary*
side of that story — a seeded, replayable schedule of faults that drives
``repro_torch.ft.resilience`` (HeartbeatMonitor / StragglerMitigator /
RestartPolicy / plan_rescale) through ``launch.train --chaos``.

Everything here is pure Python + numpy (no torch import) and runs on a
**virtual clock**: the injector advances time by the simulated step
duration instead of sleeping, so a 12-step chaos run with a 3.5 s heartbeat
timeout executes in milliseconds and is bit-reproducible from
``(chaos_seed,)`` alone.  Wall-clock discipline (lint L4) is moot by
construction — no raw clock is ever read.

Schedule format (one string, CLI- and manifest-friendly)::

    kill@5:h0,straggle@1:h1:x2.5:d2,ckpt_crash@5

comma-separated events, each ``kind@step`` plus fields:

    kill@S:hH          host H stops heartbeating after step S
    straggle@S:hH:xF:dD   host H runs F x slower for D steps from step S
    ckpt_crash@S       the next checkpoint written after step S is torn
                       (crash mid-publish; restore must skip it)

``ChaosSchedule.from_seed`` draws an equivalent schedule deterministically
from a seed; ``to_spec`` round-trips it back to the string form so every
chaos run can record exactly what was injected.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .resilience import HeartbeatMonitor, StragglerMitigator

KILL = "kill"
STRAGGLE = "straggle"
CKPT_CRASH = "ckpt_crash"
_KINDS = (KILL, STRAGGLE, CKPT_CRASH)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One injected fault.  ``host`` is the *original* host id (the id
    space never renumbers across rescales, exactly like slot ids in the
    serving engine)."""
    kind: str
    step: int
    host: int | None = None
    factor: float = 1.0        # straggle slowdown multiplier
    duration: int = 1          # straggle length in steps

    def spec(self) -> str:
        parts = [f"{self.kind}@{self.step}"]
        if self.host is not None:
            parts.append(f"h{self.host}")
        if self.kind == STRAGGLE:
            parts.append(f"x{self.factor:g}")
            parts.append(f"d{self.duration}")
        return ":".join(parts)


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    events: tuple = ()

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        events = []
        for tok in (t.strip() for t in (spec or "").split(",")):
            if not tok:
                continue
            head, _, rest = tok.partition(":")
            kind, _, step_s = head.partition("@")
            if kind not in _KINDS:
                raise ValueError(f"unknown chaos event kind {kind!r} "
                                 f"(expected one of {_KINDS})")
            host, factor, duration = None, 1.0, 1
            for field in (f for f in rest.split(":") if f):
                if field[0] == "h":
                    host = int(field[1:])
                elif field[0] == "x":
                    factor = float(field[1:])
                elif field[0] == "d":
                    duration = int(field[1:])
                else:
                    raise ValueError(f"unknown chaos event field {field!r}")
            if kind != CKPT_CRASH and host is None:
                raise ValueError(f"{kind} event needs a :hH host field: "
                                 f"{tok!r}")
            events.append(ChaosEvent(kind, int(step_s), host, factor,
                                     duration))
        return cls(tuple(sorted(events, key=lambda e: (e.step, e.kind))))

    @classmethod
    def from_seed(cls, seed: int, *, steps: int, n_hosts: int,
                  n_kills: int = 1, n_straggles: int = 1,
                  n_ckpt_crashes: int = 0,
                  straggle_factor: float = 2.5) -> "ChaosSchedule":
        """A deterministic schedule: straggles land in the first half of the
        run (so EWMAs have steps to recover), kills in the middle window (so
        a checkpoint exists before and steps remain after), each kill on a
        distinct host.  The same ``(seed, steps, n_hosts, ...)`` always
        yields the identical schedule."""
        rng = np.random.default_rng(np.random.SeedSequence([seed, steps,
                                                            n_hosts]))
        events = []
        lo, hi = max(1, steps // 3), max(2, (2 * steps) // 3)
        kill_hosts = rng.choice(n_hosts, size=min(n_kills, n_hosts - 1),
                                replace=False)
        for h in kill_hosts:
            events.append(ChaosEvent(KILL, int(rng.integers(lo, hi + 1)),
                                     int(h)))
        for _ in range(n_straggles):
            events.append(ChaosEvent(
                STRAGGLE, int(rng.integers(1, max(2, steps // 2))),
                int(rng.integers(0, n_hosts)), straggle_factor,
                int(rng.integers(1, 3))))
        for _ in range(n_ckpt_crashes):
            events.append(ChaosEvent(CKPT_CRASH,
                                     int(rng.integers(lo, hi + 1))))
        return cls(tuple(sorted(events, key=lambda e: (e.step, e.kind))))

    def to_spec(self) -> str:
        return ",".join(e.spec() for e in self.events)

    def events_at(self, step: int) -> list:
        return [e for e in self.events if e.step == step]


class VirtualClock:
    """The harness's time source: monotone, advanced explicitly.  Injected
    as the ``clock`` of HeartbeatMonitor / RestartPolicy so timeout and
    backoff semantics are exercised without a single real second passing."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, dt
        self.t += dt
        return self.t


@dataclasses.dataclass(frozen=True)
class ChaosStatus:
    """What the injector observed after one step's tick."""
    step: int
    dead: tuple = ()           # hosts the heartbeat monitor timed out
    stragglers: tuple = ()     # hosts the mitigator wants evicted
    tear_next_save: bool = False   # a ckpt_crash event fired this step
    step_s: float = 0.0        # simulated duration of this step (slowest host)

    @property
    def lost(self) -> tuple:
        return tuple(sorted(set(self.dead) | set(self.stragglers)))


class FaultInjector:
    """Applies a :class:`ChaosSchedule` to a simulated host fleet and runs
    the detection stack (heartbeats + straggler EWMA) on a virtual clock.

    The SPMD contract sets the pacing: one training step takes as long as
    the *slowest alive host* (everyone waits at the collective), so the
    clock advances by ``base_step_s * max(straggle factors)`` each tick and
    every alive host beats once per step.  A killed host simply stops
    beating; the monitor times it out ``timeout_s`` of virtual time later —
    the harness therefore models *detection latency*: steps computed
    between kill and detection are lost work, rolled back at restore.
    """

    def __init__(self, schedule: ChaosSchedule, n_hosts: int, *,
                 timeout_s: float = 3.5, base_step_s: float = 1.0,
                 straggler_threshold: float = 1.5,
                 straggler_patience: int = 3,
                 clock: VirtualClock | None = None):
        self.schedule = schedule
        self.n_hosts = n_hosts
        self.base_step_s = base_step_s
        self.timeout_s = timeout_s
        self.clock = clock if clock is not None else VirtualClock()
        self.alive: set[int] = set(range(n_hosts))
        self.failed: set[int] = set()          # killed or evicted, all-time
        self._straggles: dict[int, list] = {}  # host -> [factor, steps_left]
        self._threshold = straggler_threshold
        self._patience = straggler_patience
        self.monitor = HeartbeatMonitor(hosts=self.alive,
                                        timeout_s=timeout_s,
                                        clock=self.clock)
        self.mitigator = StragglerMitigator(threshold=straggler_threshold,
                                            patience=straggler_patience)

    def tick(self, step: int) -> ChaosStatus:
        tear = False
        for e in self.schedule.events_at(step):
            if e.kind == KILL and e.host in self.alive:
                self.alive.discard(e.host)
                self.failed.add(e.host)
            elif e.kind == STRAGGLE and e.host in self.alive:
                self._straggles[e.host] = [e.factor, e.duration]
            elif e.kind == CKPT_CRASH:
                tear = True
        # per-host durations; the slowest alive host paces the SPMD step
        durations = {}
        for h in self.alive:
            f = self._straggles.get(h, (1.0,))[0]
            durations[h] = self.base_step_s * f
        step_s = max(durations.values()) if durations else self.base_step_s
        self.clock.advance(step_s)
        for h in self.alive:
            self.monitor.beat(h, step, durations[h])
        for h in list(self._straggles):
            self._straggles[h][1] -= 1
            if self._straggles[h][1] <= 0:
                del self._straggles[h]
        dead = tuple(self.monitor.dead_hosts())
        flagged = tuple(self.mitigator.update(
            {h: self.monitor.hosts[h].ewma_step_s for h in self.alive}))
        return ChaosStatus(step=step, dead=dead, stragglers=flagged,
                           tear_next_save=tear, step_s=step_s)

    def evict(self, hosts) -> None:
        """Remove ``hosts`` from the fleet (restart path) and reset the
        detection state for the survivors — a fresh monitor epoch, beats
        starting now, straggler strike counts cleared."""
        self.alive -= set(hosts)
        self.failed |= set(hosts)
        self._straggles = {h: s for h, s in self._straggles.items()
                           if h in self.alive}
        self.monitor = HeartbeatMonitor(hosts=self.alive,
                                        timeout_s=self.timeout_s,
                                        clock=self.clock)
        self.mitigator = StragglerMitigator(threshold=self._threshold,
                                            patience=self._patience)
