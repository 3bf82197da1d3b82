"""Distributed check: ring attention over a process mesh (the counterpart of
``repro.testing.check_ring_attention``).

    PYTHONPATH=src python -m repro_torch.testing.check_dist_ring 8 --device cpu

runs 8 ranks on the CPU (gloo): the flat ring over one `data` dimension
and the hierarchical odometer over a topology (2 x 2 x 2 levels at 8
ranks, 2 x 2 at 4), causal, non-causal and with a window of 24, at
(B, S, Hq/Hkv, D) = (2, 128, 4/2, 32) f32.  Each schedule is held to
:func:`expected` (plain attention in one process) within 2e-4, the
hierarchical ring to the flat one within ``REASSOC_TOL`` (the same terms,
merged in another order), and ``schedule="db"`` to ``"seq"`` bit for bit.
``tests/test_torch_dist_ring.py`` also holds them to the JAX package's
``ref.attention``; ``chip_smoke.py`` runs (1, 16384, 32/8, 128) bf16 with
four ranks on one card (``--size full``).  Imports only the port.
"""
from __future__ import annotations

import sys

import torch

RTOL = ATOL = 2e-4
#: |hier - flat| bound: the same softmax terms, re-associated (f32)
REASSOC_TOL = 2e-6
#: (B, S, Hq, Hkv, D, dtype) and the (causal, window) cases of each size
SHAPES = {"smoke": (2, 128, 4, 2, 32, torch.float32),
          "full": (1, 16384, 32, 8, 128, torch.bfloat16)}
CASES = {"smoke": ((True, None), (False, None), (True, 24)),
         "full": ((True, None), (True, 4096))}


def inputs(size: str, device) -> tuple:
    """q (B, S, Hq, D), k and v (B, S, Hkv, D), from a fixed seed."""
    B, S, H, Hkv, D, dt = SHAPES[size]
    g = torch.Generator(device).manual_seed(0)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=device).to(dt)
               for h in (H, Hkv, Hkv))
    return q, k, v


def expected(size: str, device, causal: bool, window) -> torch.Tensor:
    """One process's attention over the whole sequence through the port's
    seam (plain f32 on the CPU, the flash kernel on the card), (B, S, H, D)."""
    from repro_torch.kernels import ops

    q, k, v = inputs(size, device)
    return ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=causal, window=window).transpose(1, 2)


def _topology(world: int):
    from repro_torch.testing.check_dist_moe import _topology as topo

    return topo(world)


def _local(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's slice of the sequence (outer-major over ``axes``)."""
    n = mesh.axis_size(axes)
    return t.chunk(n, dim=1)[mesh.index(axes)].contiguous()


def rank_main(args) -> None:
    """One rank: every case over the flat ring (seq and db) and over the
    hierarchical one; saves ``rank<r>.pt`` with its slices and its host
    ms, collective ms and bytes, and peak device memory a call."""
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.parallel.ring_attention import ring_attention
    from repro_torch.testing.subproc import join, readings

    with join(args) as world:
        dev = world.device
        flat = make_mesh(world, (world.size,), ("data",))
        topo = _topology(world.size)
        hier = make_production_mesh(world, topology=topo)
        q, k, v = inputs(args.size, dev)
        res = {"cases": {}}
        for causal, window in CASES[args.size]:
            case = {}
            for tag, mesh, kw in (("seq", flat, {}), ("db", flat, {"schedule": "db"}),
                                  ("hier", hier, {"topology": topo})):
                axes = ("data",) if mesh is flat else topo.axis_names
                ql, kl, vl = (_local(t, mesh, axes) for t in (q, k, v))
                with readings(mesh, dev) as st:
                    out = ring_attention(ql, kl, vl, mesh, axis="data", causal=causal,
                                         window=window, **kw)
                case[tag] = out.cpu()
                case[f"{tag}_stats"] = st
                del out
            case["db_same"] = torch.equal(case["seq"], case["db"])
            res["cases"][(causal, window)] = case
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def assemble(d, world: int) -> dict:
    """Every case's whole outputs (the ranks' slices in ring order), the
    db-equals-seq flags of every rank, and each rank's readings."""
    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]
    out = {}
    for key in ranks[0]["cases"]:
        cs = [r["cases"][key] for r in ranks]
        out[key] = {tag: torch.cat([c[tag] for c in cs], dim=1)
                    for tag in ("seq", "db", "hier")}
        out[key]["db_same"] = all(c["db_same"] for c in cs)
        out[key]["stats"] = {tag: [c[f"{tag}_stats"] for c in cs]
                             for tag in ("seq", "db", "hier")}
    return out


def main(argv=None) -> dict:
    from repro_torch.testing.check_dist_moe import compare
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("ring attention on a process mesh against one process")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--size", choices=tuple(SHAPES), default="smoke")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    d = run_ranks("repro_torch.testing.check_dist_ring", args.n, str(args.n),
                  "--size", args.size, device=args.device, workdir=args.dir)
    got = assemble(d, args.n)
    ok = True
    for (causal, window), r in got.items():
        want = expected(args.size, "cpu", causal, window)
        use = {t: compare(r[t], want) for t in ("seq", "hier")}
        reassoc = float((r["hier"] - r["seq"]).abs().max())
        ok &= max(use.values()) <= 1 and reassoc <= REASSOC_TOL and r["db_same"]
        print(f"check_dist_ring causal={causal} window={window}: limit use {use}, "
              f"|hier - flat| {reassoc:.2e} (limit {REASSOC_TOL}), db == seq "
              f"bitwise: {r['db_same']}")
    if not ok:
        raise AssertionError("check_dist_ring failed")
    print(f"check_dist_ring OK (n={args.n}, hier "
          f"{'x'.join(map(str, _topology(args.n).shape))})")
    return got


if __name__ == "__main__":
    main(sys.argv[1:])
