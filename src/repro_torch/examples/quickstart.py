"""Quickstart: the AraXL machine on a process mesh.

The port's twin of ``examples/quickstart.py``: an 8-lane distributed vector
machine (2 clusters x 4 lanes, the paper's building block; one rank a
lane) loads long vectors through the staged GLSU, slides and reduces over
the RINGI, and runs the paper's benchmark kernels through the vector ISA;
then the same softmax program is traced through the cycle model of a
64-lane AraXL.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
(8 ranks; on the card they share it through host buffers.)
"""
from __future__ import annotations

import sys

import numpy as np

#: the reference example's machine: C clusters x L lanes
C, L = 2, 4


def rank_main(args) -> None:
    from repro_torch.core import element_to_coords, isa_kernels, make_machine
    from repro_torch.testing.subproc import join

    with join(args) as world:
        # RVV-maximum VLEN: 64 Kibit -> 1024 elements a register
        v = make_machine(C, L, vlen_bits=65536, sew_bits=64, world=world)
        say = print if world.rank == 0 else (lambda *a, **k: None)
        n = v.spec.n_total_lanes
        say(f"ranks: {world.size} on {world.device}")
        say(f"machine: {v.spec.n_clusters} clusters x {v.spec.n_lanes} lanes, "
            f"VLMAX={v.vlmax} elements/vreg")

        # --- GLSU: memory -> striped register file (paper byte map) --------
        x = np.arange(n * n, dtype=np.float64)
        r = v.vle(x)
        b, c, l = element_to_coords(5, v.spec.n_clusters, v.spec.n_lanes)
        say(f"vle: element 5 sits at (row, cluster, lane) = ({b}, {c}, {l})")

        # --- RINGI: slide-by-1 and the 4-stage reduction --------------------
        slid = v.vslide1down(r, fill=-1.0)
        say("slide1down head:", v.vse(slid)[:6].cpu().numpy())
        say("vredsum:", float(v.vredsum(r)), "expected:", x.sum())

        # --- the paper's kernels through the ISA ----------------------------
        rng = np.random.default_rng(0)
        A = rng.normal(size=(4, 8))
        B = rng.normal(size=(8, 4 * n))
        out = isa_kernels.fmatmul(v, A, B)
        say("fmatmul max err:", float(np.abs(out - A @ B).max()))

        S = rng.normal(size=(3, 4 * n))
        sm = isa_kernels.softmax(v, S)
        say("softmax row sums:", sm.sum(axis=1))

        d = isa_kernels.fdotproduct(v, rng.normal(size=4 * n),
                                    rng.normal(size=4 * n))
        say("fdotproduct:", float(d))

        # --- trace the same program through the cycle model -----------------
        from repro_torch.sim import TraceMachine, araxl_params, simulate

        tv = TraceMachine()
        isa_kernels.softmax(tv, np.zeros((4, 64 * 64)))
        res = simulate(tv.trace, araxl_params(64))
        say(f"softmax on simulated 64-lane AraXL: {res.cycles:.0f} cycles, "
            f"FPU util {res.utilization:.1%}, "
            f"{res.flop_per_cycle:.1f} DP-FLOP/cycle")


def main(argv=None) -> str:
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("the AraXL machine on 2 x 4 ranks")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return ""
    require_device(args.device)
    d = run_ranks("repro_torch.examples.quickstart", C * L, device=args.device,
                  workdir=args.dir)
    return (d / "rank0.log").read_text()


if __name__ == "__main__":
    main(sys.argv[1:])
