"""Training launcher: a (smoke or full) model, with checkpoints and the chaos
harness.

The port's counterpart of ``repro.launch.train`` (``run``, ``run_chaos``,
``main``, with the reference's flags and its optimizer settings: ``lr``,
warmup a tenth of the steps, cosine to ``--steps``).  Runs on the card
unless ``--device cpu``; weights are random, drawn from ``--seed`` (``run``
and ``run_chaos`` also take a param tree, so a run can start from weights
carried over from JAX).  ``--arch`` takes every registered arch.  For the
cross-attention families (encdec: seamless-m4t-large-v2; vlm:
llama-3.2-vision-11b) each step's batch also carries a context of
``lm.context_len`` tokens, drawn as the reference's launcher draws it
(:func:`step_context`).

``--ckpt DIR`` checkpoints every 25 steps (``CheckpointManager``: a host
snapshot on the step loop, the write on a worker thread) and resumes from
the newest valid checkpoint there, the data pipeline rebuilt at its step,
so a resumed run continues the uninterrupted one bit for bit.  Each step
feeds the heartbeat monitor and the straggler mitigator.

``--chaos`` runs the chaos-tested elastic harness (:func:`run_chaos`): the
``n_devices`` logical devices split into ``--hosts`` simulated hosts,
while a deterministic fault injector (``ft.chaos``) kills and straggles
them on a virtual clock.  A detected loss runs the restart state machine:
``RestartPolicy`` backoff, ``plan_rescale`` onto the survivors
(``ft.rescale_rules``: the survivor mesh and its rules), restore of the
newest checkpoint that passes the torn-write gate, and bit-identical
``(seed, step)`` batch replay from the pipeline's cursor.  From the CLI
the state stays on the one device, so the same program runs before and
after a restart; ``run_chaos(..., mesh=)`` runs it on a process mesh of
real ranks (``testing/check_chaos.py --mesh``).  ``--procs`` runs each
host as an OS process with socket heartbeats and real SIGKILLs
(``ft.cluster``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 6 --ckpt /tmp/c
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --chaos --steps 8 \\
        --chaos-spec kill@2:h0 --ckpt-every 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --chaos --procs \\
        --steps 6 --hosts 2 --chaos-spec kill@2:h1
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-3.2-vision-11b --device cpu
"""
from __future__ import annotations

import argparse
import math
import sys
import tempfile
import zlib

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, tear_checkpoint)
from repro_torch.checkpoint.ckpt import gather_to_writer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, Pipeline, make_pipeline
from repro_torch.ft import (ChaosSchedule, FaultInjector, HeartbeatMonitor,
                            RestartPolicy, StragglerMitigator, plan_rescale,
                            rescale_rules, survivor_devices)
from repro_torch.models import lm
from repro_torch.params import tree_map
from repro_torch.parallel.sharding import block, default_rules, shard_tree
from repro_torch.serve.engine import resolve_device
from repro_torch.testing.timing import now
from repro_torch.train import (OptConfig, TrainState, abstract_train_state,
                               adamw_init, make_train_step)
from repro_torch.train.trainer import (init_train_state, train_state_defs,
                                       trainable)


def step_context(cfg, step: int, batch: int, seq_len: int) -> np.ndarray:
    """The frontend's embeddings for train step ``step`` of an encdec or vlm
    model, (batch, ``lm.context_len(cfg, seq_len)``, d_ctx) f32: the
    reference launcher's ``default_rng(step).normal(...) * 0.1``."""
    rng = np.random.default_rng(step)
    T = lm.context_len(cfg, seq_len)
    return (rng.normal(size=(batch, T, cfg.d_ctx)) * 0.1).astype(np.float32)


def _place_state(cfg, opt_cfg, seed: int, device, params: dict | None = None,
                 rules=None) -> TrainState:
    """A fresh train state on ``device``: weights drawn from ``seed``, or a
    copy of ``params`` (the update writes in place, so the caller's tensors
    stay as they were); under a mesh (``rules``) this rank's blocks of
    them.  A pure function of its arguments, so fresh starts and cold
    restarts are identical."""
    if params is None:
        return init_train_state(cfg, opt_cfg,
                                torch.Generator(device=device).manual_seed(seed),
                                device, rules=rules)
    p = tree_map(lambda t: t.to(device, copy=True), params)
    if rules is not None:
        p = shard_tree(p, lm.model_defs(cfg), rules, rules.mesh.rank)
    p = trainable(p)
    return TrainState(p, adamw_init(p, opt_cfg))


def _restore_state(ckpt_dir, cfg, opt_cfg, device, rules=None
                   ) -> tuple[TrainState, int]:
    """The newest valid checkpoint's state on ``device`` (each leaf
    allocated there once, from ``abstract_train_state``; under a mesh this
    rank's block of it) and its step."""
    st, step, _ = restore_checkpoint(ckpt_dir, abstract_train_state(cfg, opt_cfg),
                                     device=device, rules=rules)
    return TrainState(trainable(st.params), st.opt), int(step)


def _batch(cfg, step: int, tokens: np.ndarray, device, rules=None) -> dict:
    """The step's batch on ``device``; under a mesh this rank's rows (the
    ``batch`` rule's cut) of the tokens and the context."""
    B, S = tokens.shape
    batch = {"tokens": torch.from_numpy(tokens).to(torch.int64)}
    if cfg.family in lm.CONTEXT_FAMILIES:
        batch["ctx"] = torch.from_numpy(step_context(cfg, step, B, S))
    if rules is not None:
        batch = {k: block(v, rules.spec(("batch",) + ("",) * (v.ndim - 1)),
                          rules.mesh, rules.mesh.rank) for k, v in batch.items()}
    return {k: v.to(device) for k, v in batch.items()}


def run(arch: str, *, smoke: bool = True, steps: int = 50,
        global_batch: int = 8, seq_len: int = 64, lr: float = 3e-3,
        ckpt_dir: str | None = None, ckpt_every: int = 25,
        n_microbatches: int = 1, resume: bool = True, log_every: int = 10,
        seed: int = 0, device="cuda", params: dict | None = None) -> dict:
    """Train steps ``start_step`` to ``steps`` and return the losses.
    ``start_step`` is 0, or with ``ckpt_dir`` and ``resume`` the newest
    valid checkpoint's step there; with ``ckpt_dir`` the state is saved
    after every ``ckpt_every``-th step.  ``params`` (a tree on any device)
    replaces the seeded random init.

    Also returned: each step's seconds (host clock, ending on the loss's
    host read; the checkpoint snapshot after it is not in it), whether a
    save was being written as the step began, the checkpoint manager's
    ``timings``, and the restore's seconds (None without one)."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(2, steps // 10),
                        total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    start_step, restore_s = 0, None
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and latest_step(ckpt_dir) is not None:
        t0 = now()
        state, start_step = _restore_state(ckpt_dir, cfg, opt_cfg, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        restore_s = now() - t0
        print(f"[train] resumed from step {start_step}")
    else:
        state = _place_state(cfg, opt_cfg, seed, device, params)

    pipe = make_pipeline(dcfg, start_step=start_step)
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=n_microbatches)
    monitor = HeartbeatMonitor(n_hosts=1)
    straggler = StragglerMitigator()
    losses, step_s, in_flight = [], [], []
    try:
        for step in range(start_step, steps):
            in_flight.append(mgr is not None and mgr.in_flight())
            t0 = now()
            state, metrics = step_fn(state, _batch(cfg, step, next(pipe), device))
            loss = float(metrics["loss"])     # a host read: the step is done
            dt = now() - t0
            losses.append(loss)
            step_s.append(dt)
            monitor.beat(0, step, dt)
            straggler.update({0: monitor.hosts[0].ewma_step_s})
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt * 1e3:.0f} ms) [{device}]", flush=True)
            if mgr and (step + 1) % ckpt_every == 0:
                mgr.save_async(state, step + 1)
    finally:
        pipe.close()
        if mgr:
            mgr.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "start_step": start_step, "step_s": step_s,
            "save_in_flight": in_flight,
            "ckpt_timings": mgr.timings if mgr else [], "restore_s": restore_s}


# ---------------------------------------------------------------------------
# Chaos-tested elastic training
# ---------------------------------------------------------------------------

def _fingerprint(batch: np.ndarray) -> int:
    """Byte-exact batch identity: the replay assertion currency."""
    return zlib.crc32(np.ascontiguousarray(batch).tobytes())


def run_chaos(arch: str = "llama3-8b", *, steps: int = 12,
              chaos_seed: int = 0, chaos_spec: str | None = None,
              n_hosts: int = 2, model_axis: int = 2, global_batch: int = 8,
              seq_len: int = 32, lr: float = 3e-3, seed: int = 0,
              ckpt_dir: str | None = None, ckpt_every: int = 2,
              timeout_s: float = 3.5, base_step_s: float = 1.0,
              max_restarts: int = 3, backoff_s: float = 1.0,
              n_microbatches: int = 1, log_every: int = 1,
              n_kills: int = 1, n_straggles: int = 1,
              n_ckpt_crashes: int = 0, verbose: bool = True,
              n_devices: int = 8, device="cuda",
              params: dict | None = None, mesh=None) -> dict:
    """One elastic training run of the smoke model under injected faults.

    ``n_devices`` logical devices split into ``n_hosts`` simulated hosts
    (host h owns a contiguous block of whole data-parallel rows of the
    ``(n_devices // model_axis, model_axis)`` mesh).  Each step: pull the
    cursor's batch, train, then ``injector.tick``: beats, straggle decay
    and fault events on the virtual clock.  When the monitor times a host
    out (or the mitigator demands an eviction), the restart state machine
    runs:

        BACKOFF  RestartPolicy.next_delay (virtual seconds, budget-limited)
        RESCALE  plan_rescale drops the lost hosts' dp rows, model axis
                 intact; ft.rescale_rules gives the survivor mesh
        RESTORE  restore_checkpoint onto ``device`` (the newest checkpoint
                 passing the torn-write gate; the deterministic init if
                 none exists yet)
        REPLAY   the pipeline rebuilt at the restored cursor: the stream is
                 a pure function of (seed, step), so every batch after the
                 restart is byte-identical to the uninterrupted run's

    Without ``mesh`` the state lives on the one ``device`` throughout, so
    the steps after a restore run the same program as the uninterrupted
    run and give its losses bit for bit.  With ``mesh`` (a ``comm.Mesh``
    of ``(n_devices // model_axis, model_axis)`` over the process group's
    ranks, whose global ranks are the logical device ids; every rank calls
    ``run_chaos``) the state is placed by ``train_state_shardings``' rules
    and each rank trains on its rows: a save gathers the state to the
    mesh's first rank, which writes it before any rank goes on; a lost
    host's ranks leave the run at the restart (their result says where,
    ``left_at_step``), and the survivors build the rescaled mesh
    (``rescale_rules``), restore the checkpoint onto it and replay, on a
    mesh whose reduction order differs, as the reference's does.  Returns
    the reference's result: per-step losses and batch fingerprints, the
    restart log and timeline, the final mesh shape and the virtual seconds.
    """
    device = resolve_device(device)
    if n_devices % n_hosts:
        raise ValueError(f"{n_devices} devices not divisible into "
                         f"{n_hosts} hosts")
    devices_per_host = n_devices // n_hosts
    if n_devices % model_axis or devices_per_host % model_axis:
        raise ValueError(
            f"model axis {model_axis} must divide both the device count "
            f"{n_devices} and devices/host {devices_per_host} (hosts own whole "
            f"dp rows — AraXL loses clusters, never lanes)")
    devices = list(range(n_devices))
    mesh_shape = (n_devices // model_axis, model_axis)
    rules = None
    if mesh is not None:
        if tuple(mesh.sizes) != mesh_shape or mesh.axis_names != ("data", "model"):
            raise ValueError(f"run_chaos on a mesh wants (data, model) = "
                             f"{mesh_shape}, got {mesh.shape}")
        rules = default_rules(mesh, batch=global_batch)
    me = None if mesh is None else mesh.ranks[mesh.rank]
    speak = verbose and (mesh is None or mesh.rank == 0)

    cfg = get_smoke_config(arch)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(2, steps // 10),
                        total_steps=steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="repro_chaos_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=3)

    schedule = (ChaosSchedule.parse(chaos_spec) if chaos_spec is not None
                else ChaosSchedule.from_seed(
                    chaos_seed, steps=steps, n_hosts=n_hosts,
                    n_kills=n_kills, n_straggles=n_straggles,
                    n_ckpt_crashes=n_ckpt_crashes))
    injector = FaultInjector(schedule, n_hosts=n_hosts, timeout_s=timeout_s,
                             base_step_s=base_step_s)
    policy = RestartPolicy(max_restarts=max_restarts, backoff_s=backoff_s,
                           clock=injector.clock)

    state = _place_state(cfg, opt_cfg, seed, device, params, rules)
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=n_microbatches,
                              rules=rules)
    state_defs = TrainState(*train_state_defs(cfg, opt_cfg))
    pipe = Pipeline(dcfg, start_step=0)

    losses_by_step: dict[int, float] = {}
    fingerprints: dict[int, int] = {}
    restarts: list[dict] = []
    timeline: list[dict] = []
    tear_next_save = False
    steps_executed = 0
    step = 0
    try:
        while step < steps:
            assert pipe.cursor == step, (pipe.cursor, step)
            batch_np = next(pipe)
            fp = _fingerprint(batch_np)
            prev = fingerprints.get(step)
            assert prev is None or prev == fp, \
                f"replay diverged at step {step}: {prev} != {fp}"
            fingerprints[step] = fp
            state, metrics = step_fn(state, _batch(cfg, step, batch_np, device,
                                                   rules))
            loss = float(metrics["loss"])
            losses_by_step[step] = loss
            steps_executed += 1

            status = injector.tick(step)
            tear_next_save = tear_next_save or status.tear_next_save
            if speak and (step % log_every == 0 or step == steps - 1):
                print(f"[chaos] step {step:4d} loss {loss:8.4f} "
                      f"mesh {list(mesh_shape)} t={injector.clock():.1f}s "
                      f"alive={sorted(injector.alive)} [{device}]", flush=True)

            if (step + 1) % ckpt_every == 0:
                extra = {"mesh_shape": list(mesh_shape),
                         "global_batch": global_batch,
                         "data_cursor": pipe.cursor}
                whole = state if mesh is None else \
                    gather_to_writer(state, state_defs, rules)
                writer = whole is not None
                if writer:
                    mgr.save_async(whole, step + 1, extra=extra)
                if tear_next_save:
                    if writer:
                        mgr.wait()                 # durable, then corrupted
                        tear_checkpoint(ckpt_dir, step + 1)
                    timeline.append({"step": step, "event": "ckpt_torn",
                                     "ckpt_step": step + 1})
                    tear_next_save = False
                if mesh is not None:               # written before any rank reads
                    mgr.wait()
                    _barrier(mesh)

            lost = status.lost
            if lost:
                mgr.wait()                         # flush + surface async errors
                if not policy.should_restart():
                    raise RuntimeError(
                        f"restart budget exhausted after {policy.restarts} "
                        f"restarts (lost hosts {lost})")
                delay = policy.next_delay()
                injector.clock.advance(delay)      # virtual backoff, no sleep
                injector.evict(lost)
                restore_step = latest_step(ckpt_dir) or 0
                plan = plan_rescale(
                    old_devices=math.prod(mesh_shape), lost_hosts=len(lost),
                    devices_per_host=devices_per_host, mesh_axes=mesh_shape,
                    global_batch=global_batch, restore_step=restore_step)
                if plan.new_global_batch != global_batch:
                    raise ValueError(
                        f"global batch {global_batch} not divisible by the "
                        f"rescaled dp={plan.new_mesh_shape[0]} — bit-identical "
                        f"replay needs a batch divisible by every survivable "
                        f"dp size ({plan.notes})")
                survivors = survivor_devices(injector.failed, devices_per_host,
                                             devices)[:plan.new_devices]
                if mesh is not None and me not in survivors:
                    # this rank's host is gone: it leaves the mesh, which the
                    # survivors rebuild without it
                    return {"left_at_step": step, "losses_by_step": losses_by_step,
                            "fingerprints": fingerprints, "restarts": restarts,
                            "timeline": timeline, "steps_executed": steps_executed}
                new_mesh, rules = rescale_rules(
                    plan, injector.failed, devices_per_host, devices=devices,
                    transport=None if mesh is None else mesh.transport)
                mesh_shape = tuple(new_mesh.sizes)
                if mesh is not None:
                    mesh = new_mesh
                    step_fn = make_train_step(cfg, opt_cfg, rules=rules,
                                              n_microbatches=n_microbatches)
                else:
                    rules = None
                speak = verbose and (mesh is None or mesh.rank == 0)
                del state                          # one state on the device
                if latest_step(ckpt_dir) is not None:
                    state, rstep = _restore_state(ckpt_dir, cfg, opt_cfg, device,
                                                  rules)
                else:                              # killed before the first save
                    state, rstep = _place_state(cfg, opt_cfg, seed, device,
                                                params, rules), 0
                pipe.close()
                pipe = Pipeline(dcfg, start_step=rstep)
                restarts.append({
                    "detected_at_step": step, "lost_hosts": list(lost),
                    "restore_step": rstep, "backoff_s": delay,
                    "new_mesh_shape": list(plan.new_mesh_shape),
                    "new_devices": plan.new_devices, "notes": plan.notes})
                timeline.append({"step": step, "event": "restart",
                                 "lost": list(lost), "restore_step": rstep})
                if speak:
                    print(f"[chaos] RESTART #{len(restarts)}: lost {list(lost)} "
                          f"at step {step}, backoff {delay:.1f}s, restored "
                          f"step {rstep} onto {plan.new_mesh_shape} "
                          f"({plan.notes})", flush=True)
                step = rstep
                continue
            step += 1
    finally:
        pipe.close()
        mgr.wait()
    losses = [losses_by_step[s] for s in range(steps)]
    out = {} if mesh is None else {"left_at_step": None}
    return {**out, "losses": losses, "losses_by_step": losses_by_step,
            "final_loss": losses[-1] if losses else None,
            "fingerprints": fingerprints, "restarts": restarts,
            "n_restarts": len(restarts), "timeline": timeline,
            "chaos_spec": schedule.to_spec(), "ckpt_dir": ckpt_dir,
            "steps_executed": steps_executed,
            "final_mesh_shape": list(mesh_shape),
            "virtual_seconds": injector.clock()}


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` reaches this point before any goes on."""
    import torch.distributed as dist

    if mesh.size > 1:
        dist.barrier(group=mesh.group(mesh.axis_names))


def main(argv=None) -> dict:
    """The CLI; returns the run's result (``run``, ``run_chaos`` or the
    cluster supervisor's)."""
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    help="a registered arch: dense, MoE (mixtral-8x7b, "
                         "qwen3-moe-235b-a22b), mamba2-370m, "
                         "jamba-1.5-large-398b, seamless-m4t-large-v2 (encdec) "
                         "or llama-3.2-vision-11b (vlm)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="full published config")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory: save every 25 steps (every "
                         "--ckpt-every with --chaos) and resume from its "
                         "newest valid step")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--chaos", action="store_true",
                    help="elastic-training chaos harness: injected host "
                         "kills/straggles, checkpoint-rescale restarts, "
                         "bit-identical data replay")
    ap.add_argument("--procs", action="store_true",
                    help="with --chaos: run each simulated host as a real "
                         "OS worker process with socket heartbeats; kill@S "
                         "delivers an actual SIGKILL and detection runs on "
                         "real-clock deadlines (repro_torch.ft.cluster)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-spec", default=None,
                    metavar="kill@S:hH,straggle@S:hH:xF:dD,ckpt_crash@S",
                    help="explicit fault schedule (overrides --chaos-seed)")
    ap.add_argument("--hosts", type=int, default=2,
                    help="simulated hosts the 8 logical devices split into")
    ap.add_argument("--model-axis", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=3.5,
                    help="heartbeat timeout (virtual seconds)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.procs and not args.chaos:
        ap.error("--procs requires --chaos")
    if args.chaos and args.procs:
        from repro_torch.ft.cluster import ClusterSupervisor
        spec = args.chaos_spec
        if spec is None:
            # seeded schedule, procs-compatible events only (straggles are
            # virtual-clock-only: real slowness cannot be injected
            # deterministically into an OS process)
            spec = ChaosSchedule.from_seed(
                args.chaos_seed, steps=args.steps, n_hosts=args.hosts,
                n_kills=1, n_straggles=0, n_ckpt_crashes=0).to_spec()
        out = ClusterSupervisor(
            args.arch, steps=args.steps, n_hosts=args.hosts,
            model_axis=args.model_axis, global_batch=args.batch,
            seq_len=args.seq, lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt,
            ckpt_every=args.ckpt_every, chaos_spec=spec,
            timeout_s=args.timeout, max_restarts=args.max_restarts,
            n_microbatches=args.microbatches, device=args.device).run()
        print(f"[chaos] done (procs): {out['n_restarts']} restart(s) "
              f"across {out['epochs']} epoch(s), final mesh "
              f"{out['final_mesh_shape']}, first loss "
              f"{out['losses'][0]:.4f} final {out['final_loss']:.4f} "
              f"(schedule: {out['chaos_spec'] or 'none'})")
        return out
    if args.chaos:
        out = run_chaos(args.arch, steps=args.steps,
                        chaos_seed=args.chaos_seed,
                        chaos_spec=args.chaos_spec, n_hosts=args.hosts,
                        model_axis=args.model_axis, global_batch=args.batch,
                        seq_len=args.seq, lr=args.lr, seed=args.seed,
                        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                        timeout_s=args.timeout,
                        max_restarts=args.max_restarts,
                        n_microbatches=args.microbatches, device=args.device)
        print(f"[chaos] done: {out['n_restarts']} restart(s), "
              f"final mesh {out['final_mesh_shape']}, "
              f"first loss {out['losses'][0]:.4f} "
              f"final {out['final_loss']:.4f} "
              f"(schedule: {out['chaos_spec'] or 'none'})")
        return out
    out = run(args.arch, smoke=not args.full, steps=args.steps,
              global_batch=args.batch, seq_len=args.seq, lr=args.lr,
              ckpt_dir=args.ckpt, n_microbatches=args.microbatches,
              seed=args.seed, device=args.device)
    if out["losses"]:
        print(f"[train] done: first loss {out['losses'][0]:.4f} "
              f"final {out['final_loss']:.4f}")
    else:
        print(f"[train] done: resumed at step {out['start_step']}, "
              f"no step left")
    return out


if __name__ == "__main__":
    main()
