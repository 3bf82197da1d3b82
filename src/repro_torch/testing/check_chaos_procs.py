"""Multi-process chaos acceptance check: real SIGKILL, real clocks.

The port's twin of ``repro.testing.check_chaos_procs``: the same
elastic-training story (detection -> backoff -> rescale -> newest-valid
restore -> bit-exact replay) with every simulated host a separate OS
process heartbeating over a localhost socket, every injected fault a real
``SIGKILL`` (``repro_torch.ft.cluster``), and the primary training on
``device`` (the card unless ``--device cpu``).  Three runs:

* **reference**: no faults, one epoch, the full (4, 2) mesh of 8 logical
  devices over 4 worker processes, the uninterrupted loss curve;
* **chaos**: ``kill@4:h2,kill@4:h3,ckpt_crash@5``: two standbys are
  SIGKILLed at the step-4 fence (8 -> 4 devices), then the ``ckpt_crash``
  SIGKILLs the *writer* (the primary h0, holding its device) parked
  mid-save of the step-8 checkpoint, leaf files durable and the manifest
  never published, so the next epoch falls back to the step-4 checkpoint
  (4 -> 2 devices, the primary fails over from h0 to h1, which takes the
  device);
* **chaos again, same seed**: the same records once real detection
  latencies and backoffs are stripped.

Asserted, as the reference asserts: the restart sequence (detected by
missed socket heartbeats within the real deadline window), restore step 4
both times, byte-identical batch fingerprints against the reference, and
determinism across the two seeded chaos runs.  The losses are held **bit
for bit at every step**, not within the reference's ``POST_RESCALE_RTOL``
after the restore point: one device runs the same program in every epoch
and the restored state is the saved bits, where the reference recomputes
the tail on smaller meshes.

Usage: PYTHONPATH=src python -m repro_torch.testing.check_chaos_procs [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

#: two whole-host kills at one fence (dp 4 -> 2), then a mid-write writer
#: kill tearing the step-8 checkpoint
CHAOS_SPEC = "kill@4:h2,kill@4:h3,ckpt_crash@5"

#: the heartbeat deadline the supervisor enforces (real seconds), and the
#: slack machine load is allowed to add on top before the detection path
#: counts as broken
TIMEOUT_S = 2.0
DETECT_SLACK_S = 30.0


def _strip_timing(out: dict) -> dict:
    """The determinism contract: everything except real-clock latencies
    (detection, backoff) and log paths must replay byte-identically."""
    return {
        "losses": out["losses"],
        "fingerprints": out["fingerprints"],
        "steps_executed": out["steps_executed"],
        "final_mesh_shape": out["final_mesh_shape"],
        "epochs": out["epochs"],
        "chaos_spec": out["chaos_spec"],
        "restarts": [{k: v for k, v in r.items()
                      if k not in ("detect_s", "backoff_s")}
                     for r in out["restarts"]],
        "timeline": [{k: v for k, v in t.items() if k != "logs"}
                     for t in out["timeline"]],
    }


def main(steps: int = 10, arch: str = "llama3-8b", seed: int = 0,
         verbose: bool = False, device="cuda") -> dict:
    """The three runs, asserted; returns ``{"ref", "chaos", "again"}``
    (the supervisor's results)."""
    from repro_torch.checkpoint import valid_steps
    from repro_torch.ft.cluster import ClusterSupervisor

    common = dict(steps=steps, n_hosts=4, n_devices=8, model_axis=2,
                  global_batch=8, seq_len=32, seed=seed, ckpt_every=4,
                  timeout_s=TIMEOUT_S, beat_interval_s=0.1,
                  backoff_s=0.05, verbose=verbose, device=device)
    dirs = [tempfile.mkdtemp(prefix="check_chaos_procs_")
            for _ in ("ref", "chaos_a", "chaos_b")]
    try:
        ref = ClusterSupervisor(arch, ckpt_dir=dirs[0], **common).run()
        chaos = ClusterSupervisor(arch, chaos_spec=CHAOS_SPEC,
                                  ckpt_dir=dirs[1], **common).run()
        again = ClusterSupervisor(arch, chaos_spec=CHAOS_SPEC,
                                  ckpt_dir=dirs[2], **common).run()

        assert ref["n_restarts"] == 0, ref["restarts"]
        assert ref["final_mesh_shape"] == [4, 2], ref["final_mesh_shape"]
        assert ref["epochs"] == 1, ref["epochs"]

        # 1. the restart sequence: fence double-kill then mid-write kill,
        #    each detected by missed socket heartbeats on the real clock
        assert chaos["n_restarts"] == 2, chaos["restarts"]
        r0, r1 = chaos["restarts"]
        assert r0["lost_hosts"] == [2, 3], r0
        assert r0["new_mesh_shape"] == [2, 2], r0
        assert r0["restore_step"] == 4, r0
        assert r1["lost_hosts"] == [0], r1          # the writer died...
        assert r1["new_mesh_shape"] == [1, 2], r1
        assert r1["restore_step"] == 4, \
            (f"expected fallback to the step-4 checkpoint (step 8 was "
             f"killed mid-write, manifest unpublished), got "
             f"{r1['restore_step']}")
        assert chaos["final_mesh_shape"] == [1, 2], chaos["final_mesh_shape"]
        mid = [t for t in chaos["timeline"] if t["event"] == "ckpt_mid_kill"]
        assert mid and mid[0]["ckpt_step"] == 8 and mid[0]["host"] == 0, \
            chaos["timeline"]
        for r in (r0, r1):
            assert r["detect_s"] is not None and \
                TIMEOUT_S - 0.5 < r["detect_s"] < TIMEOUT_S + DETECT_SLACK_S, \
                (f"detection latency {r['detect_s']} outside the heartbeat-"
                 f"deadline window (timeout {TIMEOUT_S}s)")

        # 2. the failed-over survivor rewrote checkpoint 8 properly
        assert 8 in valid_steps(dirs[1]), valid_steps(dirs[1])

        # 3. bit-identical (seed, step) batch replay across both SIGKILLs
        #    and both rescales
        assert chaos["fingerprints"] == ref["fingerprints"], \
            "data replay diverged from the uninterrupted run"

        # 4. loss continuity, bit for bit on both sides of the restore
        rstep = r1["restore_step"]
        for s in range(steps):
            assert chaos["losses"][s] == ref["losses"][s], \
                (f"step {s} ({'after' if s >= rstep else 'before'} the "
                 f"restore at {rstep}) diverged: {chaos['losses'][s]} vs "
                 f"{ref['losses'][s]} (one device, one program: must be "
                 f"bit-identical)")

        # 5. determinism: the second seeded run replays the whole
        #    experiment byte-identically once real latencies are stripped
        assert _strip_timing(chaos) == _strip_timing(again), \
            "seeded chaos runs diverged (real-clock nondeterminism leaked " \
            "into the step stream)"
        assert chaos["steps_executed"] > steps, chaos["steps_executed"]

        lost_work = chaos["steps_executed"] - steps
        print(f"check_chaos_procs OK on {device} ({steps} steps, 3 real "
              f"SIGKILLs across 2 restarts; detected in "
              f"{r0['detect_s']:.2f}s/{r1['detect_s']:.2f}s via socket "
              f"heartbeats, restored step {rstep} onto "
              f"{r1['new_mesh_shape']}, {lost_work} steps of lost work "
              f"replayed bit-identically, deterministic across seeded runs)")
        return {"ref": ref, "chaos": chaos, "again": again}
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(steps=a.steps, arch=a.arch, seed=a.seed, verbose=a.verbose,
         device=a.device)
