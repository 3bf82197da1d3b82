"""Fault tolerance: heartbeats, straggler mitigation, elastic rescale.

The port's counterpart of ``repro.ft.resilience`` (pure Python; the
reference's is too, and the port may not import it).  Mechanisms, all
host-side:

* HeartbeatMonitor: every host stamps a heartbeat each step; hosts whose
  last beat is older than ``timeout`` are dead and trigger the restart
  policy.
* RestartPolicy: an exponential-backoff restart budget.
* StragglerMitigator: a per-host EWMA of step time; hosts persistently
  above ``threshold`` x median are reported for eviction.
* plan_rescale: the survivor mesh's shape (whole data-parallel rows
  dropped, the model axis intact) and batch after losing hosts.

``survivor_devices`` and ``rescale_rules`` work over **logical device
ids** (``range(n_devices)``; host h owns ``[h * devices_per_host, (h + 1)
* devices_per_host)``), which on a process mesh are the global ranks:
``rescale_rules`` gives the survivor mesh over them and the rule table
re-derived on it, as the reference's restart path does; a checkpoint then
restores onto it (``checkpoint.restore_checkpoint(..., rules=)``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.testing.timing import now


@dataclasses.dataclass
class HostState:
    last_beat: float
    step: float = 0.0
    ewma_step_s: float = 0.0


class HeartbeatMonitor:
    """Controller-side liveness: a host is dead when its last beat is
    *strictly* older than ``timeout_s`` (a beat exactly at the boundary is
    alive — slow-but-barely is the straggler path's business, not this
    one's).  A beat from a host already past the timeout revives it: the
    monitor has no memory beyond ``last_beat``, so flapping hosts are the
    restart policy's problem to rate-limit, by design.

    ``hosts`` names the fleet explicitly (e.g. the survivors after a
    rescale, in the original id space); ``n_hosts`` keeps the historical
    ``range(n)`` form."""

    def __init__(self, n_hosts: int | None = None, timeout_s: float = 60.0,
                 clock: Callable[[], float] = now, hosts=None):
        assert (n_hosts is None) != (hosts is None), \
            "pass exactly one of n_hosts= / hosts="
        ids = range(n_hosts) if hosts is None else sorted(hosts)
        self.timeout = timeout_s
        self.clock = clock
        self.hosts = {h: HostState(last_beat=clock()) for h in ids}

    def beat(self, host: int, step: int, step_s: float | None = None):
        st = self.hosts[host]
        st.last_beat = self.clock()
        st.step = step
        if step_s is not None:
            st.ewma_step_s = (0.9 * st.ewma_step_s + 0.1 * step_s
                              if st.ewma_step_s else step_s)

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_hosts()


class StragglerMitigator:
    """Flag hosts whose EWMA step time exceeds threshold x median for
    ``patience`` consecutive checks (transient slowness is tolerated, the
    AraXL way; persistent stragglers are evicted)."""

    def __init__(self, threshold: float = 1.5, patience: int = 3):
        self.threshold = threshold
        self.patience = patience
        self._counts: dict[int, int] = {}

    def update(self, ewma_by_host: dict[int, float]) -> list[int]:
        vals = sorted(v for v in ewma_by_host.values() if v > 0)
        if not vals:
            return []
        median = vals[len(vals) // 2]
        flagged = []
        for h, v in ewma_by_host.items():
            if v > self.threshold * median:
                self._counts[h] = self._counts.get(h, 0) + 1
                if self._counts[h] >= self.patience:
                    flagged.append(h)
            else:
                self._counts[h] = 0
        return flagged


@dataclasses.dataclass
class ElasticPlan:
    old_devices: int
    new_devices: int
    new_mesh_shape: tuple
    new_global_batch: int
    restore_step: int
    notes: str = ""


class RescaleError(ValueError):
    """The surviving devices cannot host the job (no survivors, or too few
    to keep the model axis intact) — the caller must abort, not retry."""


def plan_rescale(old_devices: int, lost_hosts: int, devices_per_host: int,
                 mesh_axes: tuple, global_batch: int,
                 restore_step: int) -> ElasticPlan:
    """Shrink policy: drop whole data-parallel rows (clusters) so the model
    axis stays intact — AraXL loses clusters, never lanes.  Batch is kept
    divisible by the new dp size (gradient noise scale changes are logged,
    not silently absorbed).  Raises :class:`RescaleError` when nothing
    survives or the survivors cannot hold one model-axis replica."""
    remaining = old_devices - lost_hosts * devices_per_host
    model = mesh_axes[-1]
    if remaining <= 0:
        raise RescaleError(
            f"no survivors: {lost_hosts} lost hosts x {devices_per_host} "
            f"devices >= {old_devices} total")
    if remaining < model:
        raise RescaleError(
            f"cannot keep the model axis intact: {remaining} surviving "
            f"devices < model axis {model}")
    dp = remaining // model
    new_devices = dp * model
    gb = global_batch
    while gb % dp:
        gb -= 1
    return ElasticPlan(
        old_devices=old_devices, new_devices=new_devices,
        new_mesh_shape=(dp, model), new_global_batch=gb,
        restore_step=restore_step,
        notes=f"dropped to {dp} data rows; batch {global_batch}->{gb}")


def survivor_devices(lost_hosts, devices_per_host: int, devices) -> list:
    """The devices (logical ids, ``range(n_devices)``) that remain when
    the hosts in ``lost_hosts`` (original host ids; host h owns the
    contiguous device block ``[h*devices_per_host, (h+1)*devices_per_host)``)
    are gone."""
    lost = set(lost_hosts)
    return [d for i, d in enumerate(devices)
            if i // devices_per_host not in lost]


def rescale_rules(plan: ElasticPlan, lost_hosts, devices_per_host: int,
                  devices, *, transport: str | None = None, **rule_kw):
    """The rescale -> rules plumbing: the ``(data, model)`` survivor mesh
    that ``plan`` prescribes, over the first ``plan.new_devices`` devices of
    the hosts not in ``lost_hosts`` (never renumbered, in their order), and
    ``default_rules`` re-derived on it (``batch`` the plan's global batch
    unless ``rule_kw`` says otherwise).  Returns ``(mesh, rules)``; the
    mesh's ``ranks`` are the devices' ids.  With ``transport`` (this
    process one of the survivors, the ids global ranks of its process
    group) the mesh is a group of the surviving ranks, made by them alone
    (``comm.Mesh.over_ranks``); without, an abstract mesh.  Raises
    :class:`RescaleError` when fewer survive than the plan wants."""
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules

    keep = survivor_devices(lost_hosts, devices_per_host, devices)
    if len(keep) < plan.new_devices:
        raise RescaleError(f"plan wants {plan.new_devices} devices but only "
                           f"{len(keep)} survived")
    ids = [int(d) for d in keep[: plan.new_devices]]
    names = ("data", "model")
    mesh = (Mesh(names, plan.new_mesh_shape, ranks=ids) if transport is None
            else Mesh.over_ranks(ids, plan.new_mesh_shape, names, transport))
    rule_kw.setdefault("batch", plan.new_global_batch)
    return mesh, default_rules(mesh, **rule_kw)


class RestartPolicy:
    """Exponential-backoff restart budget.

    ``max_backoff_s`` caps the delay (default 5 min — beyond that a
    flapping job should page a human, not wait longer), and the exponent
    itself is clamped *before* the float multiply: a long-lived supervisor
    that keeps calling :meth:`next_delay` past exhaustion (to log the
    would-be delay, say) must never hit ``OverflowError`` from
    ``2 ** restarts`` at restart count ~1024."""

    def __init__(self, max_restarts: int = 10, backoff_s: float = 5.0,
                 clock: Callable[[], float] = now,
                 max_backoff_s: float = 300.0):
        self.max_restarts = max_restarts
        self.backoff = backoff_s
        self.max_backoff = max_backoff_s
        self.clock = clock
        self.restarts = 0
        self._last = 0.0

    def should_restart(self) -> bool:
        return self.restarts < self.max_restarts

    def next_delay(self) -> float:
        d = self.backoff * (2.0 ** min(self.restarts, 62))
        self.restarts += 1
        return min(d, self.max_backoff)
