"""Chaos-tested elastic training check, in one process.

The port's twin of ``repro.testing.check_chaos``.  Runs the same training
twice through ``launch.train.run_chaos`` (8 logical devices in 2 hosts,
the train state on the one ``device``):

* **reference**: an empty fault schedule, N steps on the full (4, 2) mesh,
  no restarts (the uninterrupted loss curve);
* **chaos**: ``CHAOS_SPEC``, a transient straggler (tolerated, no
  eviction), a torn checkpoint (``ckpt_crash``: the newest save is
  corrupted after publish) and a host kill.  The harness must detect the
  kill by heartbeat timeout, back off, ``plan_rescale`` 8 -> 4 devices,
  restore from the *previous* durable checkpoint (skipping the torn one)
  and replay the data bit for bit.

Asserted, as the reference asserts:

1. exactly the expected restart, onto the (2, 2) survivor mesh, from the
   pre-torn checkpoint step (the torn-write gate worked);
2. batch fingerprints byte-identical per step across both runs, the steps
   recomputed after the restart included;
3. loss-curve continuity.  Here it is **bit for bit at every step**, not
   within the reference's ``POST_RESCALE_RTOL`` after the restore point:
   in one process one device runs the same program before and after the
   restart, and the restored state is the saved bits.  The
   reference recomputes the tail on a smaller mesh, whose reduction order
   differs.

**On a process mesh** (``--mesh``): 8 ranks (``testing.subproc.run_ranks``)
train the same two runs on a (4, 2) ``(data, model)`` mesh from the JAX
initialiser's smoke weights; host 0's four ranks leave at the restart, and
the four survivors rescale onto the (2, 2) mesh of ranks 4-7 and restore
the step-4 checkpoint onto it.  Asserted: 1 and 2 as above on every
surviving rank, the lost ranks leaving at the step the loss is detected,
the steps before the restore bit-equal to the mesh's uninterrupted run and
the steps after it within the reference's ``POST_RESCALE_RTOL`` /
``POST_RESCALE_ATOL`` (the survivor mesh sums in another order).

Usage: PYTHONPATH=src python -m repro_torch.testing.check_chaos [--device cpu]
       PYTHONPATH=src python -m repro_torch.testing.check_chaos --mesh [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

#: the injected schedule: straggle is transient (EWMA recovers, no
#: eviction), the ckpt_crash tears the save landing after step 6 (the
#: step-8 checkpoint), the kill at step 5 is detected ~timeout later
CHAOS_SPEC = "straggle@1:h1:x2.5:d2,ckpt_crash@6,kill@5:h0"
#: the mesh mode's tolerance after the restore: the reference's own
POST_RESCALE_RTOL = 2e-3
POST_RESCALE_ATOL = 2e-4
#: the mesh mode's geometry (the reference's: 8 devices in 2 hosts)
MESH_RANKS, MESH = 8, (4, 2)
COMMON = dict(steps=12, seed=0, n_hosts=2, model_axis=2, global_batch=8,
              seq_len=32, ckpt_every=4, timeout_s=3.5, base_step_s=1.0)


def main(steps: int = 12, arch: str = "llama3-8b", seed: int = 0,
         verbose: bool = False, device="cuda", params: dict | None = None
         ) -> dict:
    """Both runs, asserted; returns ``{"ref": ..., "chaos": ...}`` (the
    ``run_chaos`` results).  ``params`` (a smoke tree on any device)
    replaces the weights drawn from ``seed``: the card's generator draws
    other numbers than the CPU's, so a card run is held to a CPU run from
    the same tree."""
    from repro_torch.launch.train import run_chaos

    common = dict(arch=arch, steps=steps, seed=seed, n_hosts=2,
                  model_axis=2, global_batch=8, seq_len=32, ckpt_every=4,
                  timeout_s=3.5, base_step_s=1.0, verbose=verbose,
                  device=device, params=params)
    dirs = [tempfile.mkdtemp(prefix="check_chaos_") for _ in ("ref", "chaos")]
    try:
        ref = run_chaos(chaos_spec="", ckpt_dir=dirs[0], **common)
        chaos = run_chaos(chaos_spec=CHAOS_SPEC, ckpt_dir=dirs[1], **common)

        assert ref["n_restarts"] == 0, ref["restarts"]
        assert ref["final_mesh_shape"] == [4, 2], ref["final_mesh_shape"]

        # 1. the restart state machine ran, rescaled, and skipped the torn
        #    checkpoint (save 8 was torn; save 4 is the durable one)
        assert chaos["n_restarts"] == 1, chaos["restarts"]
        r = chaos["restarts"][0]
        assert r["lost_hosts"] == [0], r
        assert r["new_mesh_shape"] == [2, 2], r
        assert chaos["final_mesh_shape"] == [2, 2], chaos["final_mesh_shape"]
        assert r["restore_step"] == 4, \
            (f"expected restore from the pre-torn step-4 checkpoint, got "
             f"{r['restore_step']} (torn-write gate failed?)")
        torn = [t for t in chaos["timeline"] if t["event"] == "ckpt_torn"]
        assert torn and torn[0]["ckpt_step"] == 8, chaos["timeline"]

        # 2. bit-identical (seed, step) batch replay across kill + rescale
        assert chaos["fingerprints"] == ref["fingerprints"], \
            "data replay diverged from the uninterrupted run"

        # 3. loss-curve continuity, bit for bit on both sides of the restore
        rstep = r["restore_step"]
        for s in range(steps):
            assert chaos["losses"][s] == ref["losses"][s], \
                (f"step {s} ({'after' if s >= rstep else 'before'} the "
                 f"restore at {rstep}) diverged: {chaos['losses'][s]} vs "
                 f"{ref['losses'][s]} (one device, one program: must be "
                 f"bit-identical)")

        lost_work = chaos["steps_executed"] - steps
        print(f"check_chaos OK on {device} ({steps} steps, 1 kill + 1 torn "
              f"ckpt + 1 transient straggler; restored step {rstep} onto "
              f"{r['new_mesh_shape']}, {lost_work} steps of lost work "
              f"replayed bit-identically, every loss bit-equal to the "
              f"uninterrupted run's)")
        return {"ref": ref, "chaos": chaos}
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)


def rank_main(args) -> None:
    """One rank of the mesh mode: both runs, its result saved."""
    import torch

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import run_chaos
    from repro_torch.params import tree_map
    from repro_torch.testing import train_checks as tc
    from repro_torch.testing.subproc import join

    with join(args) as world:
        mesh = make_debug_mesh(world, *MESH)
        params = tree_map(lambda t: t.to(world.device), tc.smoke_params(args.arch))
        out = {}
        for name, spec in (("ref", ""), ("chaos", CHAOS_SPEC)):
            out[name] = run_chaos(args.arch, chaos_spec=spec,
                                  ckpt_dir=f"{args.dir}/ckpt_{name}",
                                  verbose=args.verbose, device=world.device,
                                  params=params, mesh=mesh, **COMMON)
        torch.save(out, f"{args.dir}/rank{world.rank}.pt")


def assemble(d) -> dict:
    """Every rank's two results: ``{"ref": [...], "chaos": [...]}``."""
    import torch

    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
             for r in range(MESH_RANKS)]
    return {k: [r[k] for r in ranks] for k in ("ref", "chaos")}


def check_mesh(runs: dict) -> dict:
    """The mesh mode's assertions on ``assemble``'s results; returns the
    survivors' ``{"ref": ..., "chaos": ...}``."""
    import numpy as np

    refs, chaos_all = runs["ref"], runs["chaos"]
    ref = refs[0]
    assert all(r == ref for r in refs), "the ranks' uninterrupted runs differ"
    assert ref["n_restarts"] == 0 and ref["final_mesh_shape"] == [4, 2], ref
    left = [c for c in chaos_all if c["left_at_step"] is not None]
    kept = [c for c in chaos_all if c["left_at_step"] is None]
    assert len(left) == 4 and len(kept) == 4, [c["left_at_step"] for c in chaos_all]
    chaos = kept[0]
    assert all(c == chaos for c in kept), "the survivors' records differ"
    assert chaos["n_restarts"] == 1, chaos["restarts"]
    r = chaos["restarts"][0]
    assert r["lost_hosts"] == [0] and r["new_mesh_shape"] == [2, 2], r
    assert chaos["final_mesh_shape"] == [2, 2], chaos["final_mesh_shape"]
    assert r["restore_step"] == 4, r
    assert all(c["left_at_step"] == r["detected_at_step"] for c in left), left
    torn = [t for t in chaos["timeline"] if t["event"] == "ckpt_torn"]
    assert torn and torn[0]["ckpt_step"] == 8, chaos["timeline"]
    assert chaos["fingerprints"] == ref["fingerprints"]
    rstep = r["restore_step"]
    for s in range(rstep):
        assert chaos["losses"][s] == ref["losses"][s], (s, chaos["losses"][s],
                                                          ref["losses"][s])
    np.testing.assert_allclose(chaos["losses"][rstep:], ref["losses"][rstep:],
                               rtol=POST_RESCALE_RTOL, atol=POST_RESCALE_ATOL)
    return {"ref": ref, "chaos": chaos}


def main_mesh(argv=None) -> dict:
    """The mesh mode's launcher (and, with ``--rank``, one rank)."""
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("the chaos harness on 8 ranks, (4, 2) -> (2, 2)")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    extra = ["--mesh", "--arch", args.arch] + (["--verbose"] if args.verbose else [])
    d = run_ranks("repro_torch.testing.check_chaos", MESH_RANKS, *extra,
                  device=args.device, workdir=args.dir, timeout=600)
    out = check_mesh(assemble(d))
    c = out["chaos"]
    print(f"check_chaos --mesh OK on {args.device} ({MESH_RANKS} ranks: "
          f"restored step {c['restarts'][0]['restore_step']} onto "
          f"{c['final_mesh_shape']}; losses {c['losses']})")
    return out


if __name__ == "__main__":
    if "--mesh" in sys.argv[1:]:
        main_mesh(sys.argv[1:])
        sys.exit(0)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(steps=a.steps, arch=a.arch, seed=a.seed, verbose=a.verbose,
         device=a.device)
