"""Multi-process chaos: real worker death, socket heartbeats, real clocks.

The port's counterpart of ``repro.ft.cluster``.  The in-process chaos
harness (``launch.train --chaos``, ``ft/chaos.py``) runs every "host" inside
one process on a virtual clock; this module drives the same restart state
machine (``HeartbeatMonitor`` / ``RestartPolicy`` / ``plan_rescale``) by
**actual OS process death**:

* each simulated host is a separate worker process
  (``python -m repro_torch.ft.cluster --worker SPEC``, in the
  ``repro_torch.testing.subproc`` env);
* every worker stamps heartbeats over a localhost TCP socket
  (newline-delimited JSON) from a dedicated timer thread, so liveness is
  decoupled from a long kernel build or step;
* ``kill@S:hH`` delivers a real ``SIGKILL`` to the victim's PID, and
  ``ckpt_crash@S`` SIGKILLs the checkpoint *writer* parked mid-save
  (leaf files durable, manifest unpublished) — the torn state the
  crash-atomic write discipline in ``repro_torch.checkpoint`` must survive;
* the supervisor detects the loss by **missed heartbeats on a real
  monotonic clock** (``repro_torch.testing.timing.monotonic``, the
  liveness-deadline clock), then backs off, rescales, and respawns the
  survivors on the shrunk mesh.

Single-controller emulation keeps compute at 1x: only the elected primary
(lowest alive host id) trains, on the one ``device`` (the card unless
``device="cpu"``); the mesh is ``n_devices`` logical ids the hosts split,
as ``ft.resilience`` counts them.  Standby hosts are real killable PIDs
that only heartbeat: they import neither torch nor CUDA.  Losing a standby
still costs its logical devices, exactly the dp-row arithmetic of
``plan_rescale``.  When the primary dies (a ``ckpt_crash`` kills it
mid-save, holding its CUDA context), the next epoch's primary takes the
card.

Determinism under a real clock uses one trick: a ``kill@S`` makes the
primary emit step ``S``'s records, send a ``fence``, and *stall* —
modelling the SPMD survivors blocking at the next all-reduce when a peer
dies.  The SIGKILL, the socket going quiet, and the heartbeat-timeout
detection are all real and really timed, but *which step* the fleet had
reached is pinned, so two seeded runs replay identically
(``repro_torch.testing.check_chaos_procs`` asserts exactly that).

Wire format (worker -> supervisor; one JSON object per ``\\n`` line)::

    {"kind": "hello", "host": 1, "pid": 4242, "role": "standby"}
    {"kind": "beat",  "host": 1, "n": 17}
    {"kind": "epoch", "host": 0, "restore_step": 4, "mesh_shape": [3, 2]}
    {"kind": "step",  "host": 0, "step": 5, "loss": 6.91, "fp": 123456}
    {"kind": "ckpt",  "host": 0, "step": 8}
    {"kind": "ckpt_mid", "host": 0, "step": 8}      # parked mid-save
    {"kind": "fence", "host": 0, "step": 3}         # stalled at collective
    {"kind": "done",  "host": 0, "steps": 10}
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import selectors
import socket
import subprocess
import sys
import tempfile
import threading
import time

from repro_torch.ft.chaos import CKPT_CRASH, KILL, STRAGGLE, ChaosSchedule
from repro_torch.ft.resilience import (HeartbeatMonitor, RestartPolicy,
                                       plan_rescale)
from repro_torch.testing.subproc import pinned_env
from repro_torch.testing.timing import monotonic

_LOOPBACK = "127.0.0.1"
ROLE_PRIMARY = "primary"
ROLE_STANDBY = "standby"


# ---------------------------------------------------------------------------
# Wire protocol: newline-delimited JSON over a localhost socket
# ---------------------------------------------------------------------------

def encode_msg(msg: dict) -> bytes:
    """One wire frame: compact JSON + ``\\n`` (no newlines inside JSON)."""
    return json.dumps(msg, separators=(",", ":")).encode() + b"\n"


class Framer:
    """Reassemble newline-delimited JSON from an arbitrary byte stream —
    TCP gives no message boundaries, so frames split/merge under load."""

    def __init__(self):
        self._buf = b""

    def feed(self, data: bytes) -> list[dict]:
        self._buf += data
        *lines, self._buf = self._buf.split(b"\n")
        return [json.loads(line) for line in lines if line]


class Channel:
    """Worker-side sender.  The heartbeat timer thread and the training
    thread share one socket; the lock keeps frames from interleaving."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._lock = threading.Lock()

    def send(self, msg: dict) -> None:
        with self._lock:
            self.sock.sendall(encode_msg(msg))


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkerSpec:
    """Everything one worker process needs, shipped as argv JSON.

    ``fence_steps`` and ``ckpt_hold_step`` are the determinism anchors:
    the primary stalls after those steps (modelling the collective stall)
    so the supervisor's real SIGKILL always lands at the same point in the
    step stream.  ``failed`` is the all-time lost-host set (original id
    space) from which the worker derives the survivor mesh; ``device`` is
    where the primary trains (a standby never touches it)."""
    host: int
    n_hosts: int
    port: int
    role: str = ROLE_STANDBY
    devices_per_host: int = 1
    model_axis: int = 1
    arch: str = "llama3-8b"
    steps: int = 0
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 32
    lr: float = 3e-3
    n_microbatches: int = 1
    ckpt_dir: str = ""
    ckpt_every: int = 4
    failed: list = dataclasses.field(default_factory=list)
    fence_steps: list = dataclasses.field(default_factory=list)
    ckpt_hold_step: int | None = None
    beat_interval_s: float = 0.1
    device: str = "cuda"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "WorkerSpec":
        return cls(**json.loads(s))


def spawn_worker(spec: WorkerSpec, logdir: str | pathlib.Path,
                 ) -> tuple[subprocess.Popen, pathlib.Path]:
    """Launch one worker OS process in the pinned env; stdout+stderr go to
    a per-worker log whose tail is surfaced on abnormal death."""
    log_path = pathlib.Path(logdir) / f"worker_h{spec.host}.log"
    log = open(log_path, "ab")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.ft.cluster", "--worker",
             spec.to_json()],
            env=pinned_env(), stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, log_path


def _beat_loop(chan: Channel, spec: WorkerSpec,
               stop: threading.Event) -> None:
    """Dedicated heartbeat thread: liveness must keep flowing while the
    main thread sits in a kernel build, a long step or a (simulated)
    collective stall."""
    n = 0
    while not stop.is_set():
        try:
            chan.send({"kind": "beat", "host": spec.host, "n": n})
        except OSError:
            return                     # supervisor gone; main thread exits
        n += 1
        time.sleep(spec.beat_interval_s)


def _await_supervisor(chan: Channel) -> None:
    """Park forever (heartbeats continue from the timer thread).  The
    supervisor never sends, so a read returning means EOF: it is gone and
    this worker must not linger as an orphan."""
    chan.sock.settimeout(None)
    try:
        while chan.sock.recv(4096):
            pass
    except OSError:
        pass
    os._exit(1)


def _save_ckpt(chan: Channel, spec: WorkerSpec, state, ckpt_step: int,
               cursor: int, mesh_shape: list) -> None:
    """A synchronous save (the step loop waits for it, so the state's own
    tensors are written, each copied to the host as it is reached).  At
    ``ckpt_hold_step`` the writer parks after the first leaf is durable,
    the manifest unpublished, until the supervisor's SIGKILL."""
    from repro_torch.checkpoint import save_checkpoint

    hook = None
    if spec.ckpt_hold_step == ckpt_step:
        def hook(i: int) -> None:
            if i == 0:       # first leaf durable; the manifest never lands
                chan.send({"kind": "ckpt_mid", "host": spec.host,
                           "step": ckpt_step})
                _await_supervisor(chan)
    save_checkpoint(spec.ckpt_dir, state, ckpt_step,
                    extra={"mesh_shape": mesh_shape,
                           "global_batch": spec.global_batch,
                           "data_cursor": cursor},
                    after_leaf=hook)
    chan.send({"kind": "ckpt", "host": spec.host, "step": ckpt_step})


def _train_epoch(chan: Channel, spec: WorkerSpec) -> None:
    """The primary's epoch: survivor mesh, newest-valid-checkpoint restore
    (or deterministic init) onto ``spec.device``, replay from the cursor,
    per-step loss + batch fingerprint records: the in-process
    ``run_chaos`` loop, relocated into a killable worker.  torch is
    imported here only: standby workers never pay for it."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.ft.resilience import survivor_devices
    from repro_torch.launch.train import (_batch, _fingerprint, _place_state,
                                          _restore_state)
    from repro_torch.serve.engine import resolve_device
    from repro_torch.train import OptConfig, make_train_step

    device = resolve_device(spec.device)
    cfg = get_smoke_config(spec.arch)
    opt_cfg = OptConfig(lr=spec.lr, warmup_steps=max(2, spec.steps // 10),
                        total_steps=spec.steps)
    keep = survivor_devices(spec.failed, spec.devices_per_host,
                            range(spec.n_hosts * spec.devices_per_host))
    dp = len(keep) // spec.model_axis
    if latest_step(spec.ckpt_dir) is not None:
        state, rstep = _restore_state(spec.ckpt_dir, cfg, opt_cfg, device)
    else:
        state, rstep = _place_state(cfg, opt_cfg, spec.seed, device), 0
    chan.send({"kind": "epoch", "host": spec.host, "restore_step": rstep,
               "mesh_shape": [dp, spec.model_axis]})

    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=spec.n_microbatches)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec.seq_len,
                      global_batch=spec.global_batch, seed=spec.seed)
    pipe = Pipeline(dcfg, start_step=rstep)
    fences = set(spec.fence_steps)
    for step in range(rstep, spec.steps):
        batch_np = next(pipe)
        state, metrics = step_fn(state, _batch(cfg, step, batch_np, device))
        chan.send({"kind": "step", "host": spec.host, "step": step,
                   "loss": float(metrics["loss"]),
                   "fp": _fingerprint(batch_np)})
        if (step + 1) % spec.ckpt_every == 0:
            _save_ckpt(chan, spec, state, step + 1, pipe.cursor,
                       [dp, spec.model_axis])
        if step in fences:
            # a peer is about to be SIGKILLed: real SPMD survivors would
            # block at the next collective — model that stall for real
            chan.send({"kind": "fence", "host": spec.host, "step": step})
            pipe.close()
            _await_supervisor(chan)
    pipe.close()
    chan.send({"kind": "done", "host": spec.host, "steps": spec.steps})


def _take_device(spec: WorkerSpec) -> None:
    """The primary loads torch and the training modules, and initialises
    its device, before its hello: loading libtorch and CUDA's
    initialisation hold the interpreter lock for seconds, and the
    heartbeat thread would spend them silent inside the monitor's
    deadline."""
    import torch

    from repro_torch.launch import train  # noqa: F401 (the epoch's modules)
    from repro_torch.serve.engine import resolve_device

    if resolve_device(spec.device).type == "cuda":
        torch.cuda.init()


def worker_main(spec_json: str) -> int:
    spec = WorkerSpec.from_json(spec_json)
    if spec.role == ROLE_PRIMARY:
        _take_device(spec)
    sock = socket.create_connection((_LOOPBACK, spec.port), timeout=10.0)
    chan = Channel(sock)
    chan.send({"kind": "hello", "host": spec.host, "pid": os.getpid(),
               "role": spec.role})
    stop = threading.Event()
    threading.Thread(target=_beat_loop, args=(chan, spec, stop),
                     daemon=True).start()
    if spec.role == ROLE_PRIMARY:
        _train_epoch(chan, spec)
        stop.set()
        sock.close()
        return 0
    _await_supervisor(chan)            # standby: heartbeat until killed
    return 1


# ---------------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------------

class _EpochIO:
    """Supervisor-side socket plumbing for one epoch: accept connections,
    reassemble frames, swallow EOFs (a SIGKILLed worker's socket closes
    instantly, but *detection authority stays with the heartbeat
    timeout* — that is the mechanism under test)."""

    def __init__(self, listener: socket.socket):
        self.listener = listener
        self.sel = selectors.DefaultSelector()
        self.sel.register(listener, selectors.EVENT_READ, "listener")
        self._framers: dict[socket.socket, Framer] = {}

    def poll(self, timeout: float = 0.05) -> list[dict]:
        out: list[dict] = []
        for key, _ in self.sel.select(timeout):
            if key.data == "listener":
                conn, _ = self.listener.accept()
                conn.setblocking(False)
                self.sel.register(conn, selectors.EVENT_READ, "conn")
                self._framers[conn] = Framer()
                continue
            conn = key.fileobj
            try:
                data = conn.recv(65536)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                data = b""
            if not data:
                self.sel.unregister(conn)
                conn.close()
                self._framers.pop(conn, None)
                continue
            out.extend(self._framers[conn].feed(data))
        return out

    def close(self) -> None:
        for conn in list(self._framers):
            try:
                self.sel.unregister(conn)
            except (KeyError, ValueError):
                pass
            conn.close()
        self._framers.clear()
        self.sel.close()


def _tail(log_path: pathlib.Path, n: int = 20) -> str:
    try:
        lines = log_path.read_text(errors="replace").splitlines()
    except OSError:
        return f"<no log at {log_path}>"
    return "\n".join(lines[-n:])


def _reap(procs, grace_s: float = 10.0) -> None:
    """SIGTERM every still-running worker, escalate to SIGKILL after the
    grace period — the supervisor never leaves orphans."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class ClusterSupervisor:
    """Drive one elastic training run across real worker processes.

    Per epoch: spawn one worker per alive host (lowest id is the primary
    trainer, on ``device``; the rest heartbeat-only standbys), collect
    hellos, then arm the ``HeartbeatMonitor`` on the real monotonic clock.  Faults from the
    schedule are delivered as real SIGKILLs — at a ``fence`` for plain
    kills, at ``ckpt_mid`` (writer parked mid-save by the ``after_leaf``
    hook) for ``ckpt_crash``.  When every expected victim has missed its
    heartbeat deadline, the epoch is torn down and the restart state machine
    runs for real: ``RestartPolicy`` backoff (a real sleep),
    ``plan_rescale`` over the survivors, respawn, newest-valid-checkpoint
    restore, bit-exact replay.  ``run()`` returns the ``run_chaos`` result
    shape plus real detection latencies.  ``n_devices`` is the logical
    device count the hosts split (the mesh arithmetic); ``device`` must be
    usable here (``resolve_device``) before any worker is spawned.
    """

    def __init__(self, arch: str = "llama3-8b", *, steps: int = 10,
                 n_hosts: int = 4, n_devices: int = 8, model_axis: int = 2,
                 global_batch: int = 8, seq_len: int = 32, lr: float = 3e-3,
                 seed: int = 0, ckpt_dir: str | None = None,
                 ckpt_every: int = 4, chaos_spec: str | None = None,
                 timeout_s: float = 2.5, beat_interval_s: float = 0.1,
                 max_restarts: int = 3, backoff_s: float = 0.05,
                 max_backoff_s: float = 1.0, n_microbatches: int = 1,
                 spawn_timeout_s: float = 300.0, logdir: str | None = None,
                 verbose: bool = True, device="cuda"):
        if n_devices % n_hosts:
            raise ValueError(f"{n_devices} devices not divisible into "
                             f"{n_hosts} hosts")
        self.dph = n_devices // n_hosts
        if n_devices % model_axis or self.dph % model_axis:
            raise ValueError(
                f"model axis {model_axis} must divide both the device count "
                f"{n_devices} and devices/host {self.dph} (hosts own whole "
                f"dp rows — AraXL loses clusters, never lanes)")
        self.schedule = ChaosSchedule.parse(chaos_spec or "")
        bad = [e.kind for e in self.schedule.events if e.kind == STRAGGLE]
        if bad:
            raise ValueError(
                "straggle events are virtual-clock-only (deterministic real "
                "slowness cannot be injected into an OS process); --procs "
                "supports kill and ckpt_crash")
        from repro_torch.serve.engine import resolve_device

        self.device = str(resolve_device(device))
        self.arch, self.steps, self.seed = arch, steps, seed
        self.n_hosts, self.n_devices = n_hosts, n_devices
        self.model_axis = model_axis
        self.global_batch, self.seq_len, self.lr = global_batch, seq_len, lr
        self.n_microbatches = n_microbatches
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(
            prefix="repro_chaos_procs_ckpt_")
        self.ckpt_every = ckpt_every
        self.timeout_s = timeout_s
        self.beat_interval_s = beat_interval_s
        self.max_restarts, self.backoff_s = max_restarts, backoff_s
        self.max_backoff_s = max_backoff_s
        self.spawn_timeout_s = spawn_timeout_s
        self.logdir = logdir or tempfile.mkdtemp(prefix="repro_chaos_procs_")
        self.verbose = verbose

    # -- fault bookkeeping --------------------------------------------------

    def _consume_ckpt_crash(self) -> None:
        for e in self._pending:
            if e.kind == CKPT_CRASH:
                self._pending.remove(e)
                return

    def _next_hold_step(self) -> int | None:
        """The checkpoint step the next pending ``ckpt_crash`` tears: the
        first save strictly after the event step (same semantics as the
        virtual injector's tear-next-save)."""
        for e in self._pending:
            if e.kind == CKPT_CRASH:
                return (e.step // self.ckpt_every + 1) * self.ckpt_every
        return None

    # -- epoch --------------------------------------------------------------

    def _run_epoch(self, listener, procs, logs, alive, primary,
                   expected_restore, expected_mesh):
        """Returns ``None`` when the primary finishes, else
        ``(lost_hosts, detect_s, last_step)`` once every expected victim
        has missed its heartbeat deadline."""
        io = _EpochIO(listener)
        monitor = None
        hello: set[int] = set()
        expected_dead: set[int] = set()
        kill_at = None
        last_step = None
        hello_deadline = monotonic() + self.spawn_timeout_s
        try:
            while True:
                for msg in io.poll():
                    kind, h = msg["kind"], msg.get("host")
                    if kind == "hello":
                        hello.add(h)
                        if monitor is None and hello >= set(alive):
                            monitor = HeartbeatMonitor(
                                hosts=alive, timeout_s=self.timeout_s,
                                clock=monotonic)
                    elif kind == "beat":
                        if monitor is not None and h in monitor.hosts:
                            monitor.beat(h, msg["n"])
                    elif kind == "epoch":
                        assert msg["restore_step"] == expected_restore, \
                            (msg, expected_restore)
                        assert msg["mesh_shape"] == expected_mesh, \
                            (msg, expected_mesh)
                        self._timeline.append(
                            {"event": "epoch", "host": h,
                             "restore_step": msg["restore_step"],
                             "mesh_shape": msg["mesh_shape"]})
                    elif kind == "step":
                        s = msg["step"]
                        prev = self._fps.get(s)
                        assert prev is None or prev == msg["fp"], \
                            f"replay diverged at step {s}: " \
                            f"{prev} != {msg['fp']}"
                        self._fps[s] = msg["fp"]
                        self._losses[s] = msg["loss"]
                        self._steps_executed += 1
                        last_step = s
                    elif kind == "ckpt":
                        self._timeline.append({"event": "ckpt",
                                               "step": msg["step"]})
                    elif kind == "ckpt_mid":
                        # the writer is parked mid-save: kill it for real
                        self._consume_ckpt_crash()
                        self._timeline.append({"event": "ckpt_mid_kill",
                                               "ckpt_step": msg["step"],
                                               "host": h})
                        procs[h].kill()
                        expected_dead.add(h)
                        kill_at = monotonic()
                    elif kind == "fence":
                        victims = [e.host for e in self._pending
                                   if e.kind == KILL
                                   and e.step == msg["step"]
                                   and e.host in alive]
                        self._pending = [
                            e for e in self._pending
                            if not (e.kind == KILL and e.step == msg["step"]
                                    and e.host in alive)]
                        self._timeline.append({"event": "fence",
                                               "step": msg["step"],
                                               "kills": victims})
                        for v in victims:
                            procs[v].kill()
                            expected_dead.add(v)
                        kill_at = monotonic()
                    elif kind == "done":
                        return None
                if monitor is None:
                    if monotonic() > hello_deadline:
                        raise RuntimeError(
                            f"workers failed to connect within "
                            f"{self.spawn_timeout_s}s; logs: " +
                            "; ".join(str(p) for p in logs.values()))
                    for h2, p in procs.items():
                        if h2 not in hello and p.poll() is not None:
                            raise RuntimeError(
                                f"worker h{h2} died before hello "
                                f"(rc={p.returncode})\n{_tail(logs[h2])}")
                    continue
                dead = set(monitor.dead_hosts())
                if dead and expected_dead <= dead:
                    detect_s = (monotonic() - kill_at
                                if kill_at is not None else None)
                    if not expected_dead:
                        # died without an injected fault: surface the logs,
                        # then drive the restart machine anyway — that IS
                        # the production path
                        self._timeline.append(
                            {"event": "unexpected_loss",
                             "hosts": sorted(dead),
                             "logs": {h3: _tail(logs[h3]) for h3 in dead}})
                    return dead, detect_s, last_step
        finally:
            io.close()
            _reap(procs.values())

    # -- run ----------------------------------------------------------------

    def run(self) -> dict:
        from repro_torch.checkpoint import latest_step

        listener = socket.socket()
        listener.bind((_LOOPBACK, 0))
        listener.listen(self.n_hosts + 2)
        port = listener.getsockname()[1]

        self._pending = list(self.schedule.events)
        self._losses: dict[int, float] = {}
        self._fps: dict[int, int] = {}
        self._timeline: list[dict] = []
        self._steps_executed = 0
        restarts: list[dict] = []
        policy = RestartPolicy(max_restarts=self.max_restarts,
                               backoff_s=self.backoff_s, clock=monotonic,
                               max_backoff_s=self.max_backoff_s)
        failed: set[int] = set()
        expected_restore = latest_step(self.ckpt_dir) or 0
        expected_mesh = [self.n_devices // self.model_axis, self.model_axis]
        epochs = 0
        try:
            while True:
                epochs += 1
                alive = sorted(set(range(self.n_hosts)) - failed)
                primary = alive[0]
                kill_steps = sorted({e.step for e in self._pending
                                     if e.kind == KILL and e.host in alive})
                hold = self._next_hold_step()
                if self.verbose:
                    print(f"[cluster] epoch {epochs}: hosts {alive}, "
                          f"primary h{primary}, mesh {expected_mesh}, "
                          f"restore {expected_restore}", flush=True)
                procs, logs = {}, {}
                for h in alive:
                    is_primary = h == primary
                    spec = WorkerSpec(
                        host=h, n_hosts=self.n_hosts, port=port,
                        role=ROLE_PRIMARY if is_primary else ROLE_STANDBY,
                        devices_per_host=self.dph,
                        model_axis=self.model_axis, arch=self.arch,
                        steps=self.steps, seed=self.seed,
                        global_batch=self.global_batch,
                        seq_len=self.seq_len, lr=self.lr,
                        n_microbatches=self.n_microbatches,
                        ckpt_dir=self.ckpt_dir, ckpt_every=self.ckpt_every,
                        failed=sorted(failed),
                        fence_steps=kill_steps if is_primary else [],
                        ckpt_hold_step=hold if is_primary else None,
                        beat_interval_s=self.beat_interval_s,
                        device=self.device)
                    procs[h], logs[h] = spawn_worker(spec, self.logdir)
                outcome = self._run_epoch(listener, procs, logs, alive,
                                          primary, expected_restore,
                                          expected_mesh)
                if outcome is None:
                    break
                lost, detect_s, last_step = outcome
                if not policy.should_restart():
                    raise RuntimeError(
                        f"restart budget exhausted after {policy.restarts} "
                        f"restarts (lost {sorted(lost)}); worker logs under "
                        f"{self.logdir}")
                delay = policy.next_delay()
                time.sleep(delay)              # real backoff on a real clock
                failed |= set(lost)
                plan = plan_rescale(
                    old_devices=len(alive) * self.dph,
                    lost_hosts=len(lost), devices_per_host=self.dph,
                    mesh_axes=tuple(expected_mesh),
                    global_batch=self.global_batch,
                    restore_step=latest_step(self.ckpt_dir) or 0)
                if plan.new_global_batch != self.global_batch:
                    raise ValueError(
                        f"global batch {self.global_batch} not divisible by "
                        f"the rescaled dp={plan.new_mesh_shape[0]} — "
                        f"bit-identical replay needs a batch divisible by "
                        f"every survivable dp size ({plan.notes})")
                restarts.append({
                    "detected_at_step": last_step,
                    "lost_hosts": sorted(lost),
                    "restore_step": plan.restore_step,
                    "new_mesh_shape": list(plan.new_mesh_shape),
                    "new_devices": plan.new_devices, "notes": plan.notes,
                    "detect_s": detect_s, "backoff_s": delay})
                self._timeline.append({"event": "restart",
                                       "lost": sorted(lost),
                                       "restore_step": plan.restore_step})
                if self.verbose:
                    det = (f"detected in {detect_s:.2f}s"
                           if detect_s is not None else "uninjected loss")
                    print(f"[cluster] RESTART #{len(restarts)}: lost "
                          f"{sorted(lost)} ({det}), restore step "
                          f"{plan.restore_step} onto {plan.new_mesh_shape}",
                          flush=True)
                expected_restore = plan.restore_step
                expected_mesh = list(plan.new_mesh_shape)
        finally:
            listener.close()
        losses = [self._losses[s] for s in range(self.steps)]
        return {"losses": losses, "losses_by_step": self._losses,
                "final_loss": losses[-1] if losses else None,
                "fingerprints": self._fps, "restarts": restarts,
                "n_restarts": len(restarts), "timeline": self._timeline,
                "chaos_spec": self.schedule.to_spec(),
                "ckpt_dir": self.ckpt_dir, "logdir": self.logdir,
                "steps_executed": self._steps_executed,
                "final_mesh_shape": expected_mesh, "epochs": epochs,
                "mode": "procs"}


# ---------------------------------------------------------------------------
# Heartbeat drill: no torch in any process
# ---------------------------------------------------------------------------

def drill(n_workers: int = 2, kill_host: int = 1, *, timeout_s: float = 1.0,
          beat_interval_s: float = 0.05, deadline_s: float = 120.0) -> dict:
    """SIGKILL one heartbeat-only worker and time the monitor detecting it.

    The tentpole's mechanism in isolation: real processes, real socket
    beats, a real SIGKILL, detection purely by missed-heartbeat deadline
    on the monotonic clock.  Workers are standby-role (no torch import), so
    the whole drill runs in a couple of seconds.  Returns
    ``{"dead": [...], "detect_s": ...}``."""
    assert 0 <= kill_host < n_workers
    listener = socket.socket()
    listener.bind((_LOOPBACK, 0))
    listener.listen(n_workers + 2)
    port = listener.getsockname()[1]
    logdir = tempfile.mkdtemp(prefix="repro_drill_")
    procs, logs = {}, {}
    for h in range(n_workers):
        spec = WorkerSpec(host=h, n_hosts=n_workers, port=port,
                          role=ROLE_STANDBY, beat_interval_s=beat_interval_s)
        procs[h], logs[h] = spawn_worker(spec, logdir)
    io = _EpochIO(listener)
    monitor = None
    kill_at = None
    deadline = monotonic() + deadline_s
    try:
        hello: set[int] = set()
        while monotonic() < deadline:
            for msg in io.poll():
                if msg["kind"] == "hello":
                    hello.add(msg["host"])
                    if monitor is None and len(hello) == n_workers:
                        monitor = HeartbeatMonitor(
                            hosts=range(n_workers), timeout_s=timeout_s,
                            clock=monotonic)
                elif msg["kind"] == "beat" and monitor is not None:
                    monitor.beat(msg["host"], msg["n"])
            if monitor is None:
                continue
            if kill_at is None:
                procs[kill_host].kill()        # a real SIGKILL
                kill_at = monotonic()
            dead = monitor.dead_hosts()
            if kill_host in dead:
                return {"dead": sorted(dead),
                        "detect_s": monotonic() - kill_at}
        raise RuntimeError(
            f"drill timed out after {deadline_s}s; logs under {logdir}: " +
            "; ".join(_tail(p, 5) for p in logs.values()))
    finally:
        io.close()
        _reap(procs.values())
        listener.close()


# ---------------------------------------------------------------------------
# CLI (`python -m repro_torch.ft.cluster`; `--worker` is the child entry point)
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-process chaos supervisor")
    ap.add_argument("--worker", metavar="SPEC_JSON", default=None,
                    help=argparse.SUPPRESS)   # internal child entry point
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--model-axis", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--chaos-spec", default=None,
                    metavar="kill@S:hH,ckpt_crash@S")
    ap.add_argument("--timeout", type=float, default=2.5,
                    help="heartbeat timeout (real seconds)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="where the primary trains")
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker_main(args.worker)
    sup = ClusterSupervisor(
        args.arch, steps=args.steps, n_hosts=args.hosts,
        n_devices=args.devices, model_axis=args.model_axis,
        global_batch=args.batch, seq_len=args.seq, seed=args.seed,
        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        chaos_spec=args.chaos_spec, timeout_s=args.timeout,
        max_restarts=args.max_restarts, device=args.device)
    out = sup.run()
    print(f"[cluster] done: {out['n_restarts']} restart(s) across "
          f"{out['epochs']} epoch(s), final mesh {out['final_mesh_shape']}, "
          f"first loss {out['losses'][0]:.4f} final {out['final_loss']:.4f} "
          f"(schedule: {out['chaos_spec'] or 'none'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
