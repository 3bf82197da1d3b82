"""Long context through hierarchical ring attention.

The port's twin of ``examples/long_context.py``: a 2,048-token sequence cut
over a 2 x 4 topology (clusters of lanes, one rank a lane), the K/V blocks
rotating as an odometer (the lane ring turns every step, the cluster ring
once per lane cycle, so the long wires carry 1/4 of the steps), held
against one process's attention over the whole sequence.

Run:  PYTHONPATH=src python -m repro_torch.examples.long_context [--device cpu]
(8 ranks; on the card they share it through host buffers.)
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.topology import Topology

#: the reference example's machine and shape: (B, S per rank, Hq, Hkv, D)
TOPOLOGY = Topology(2, 4, cluster_axis="cluster", lane_axis="lane")
B, S_RANK, H, HKV, D = 1, 256, 8, 2, 64
WINDOW = 512


def inputs(device) -> tuple:
    """q, k, v (B, S, H|Hkv, D) bf16 from the reference example's seed."""
    n = TOPOLOGY.shape[0] * TOPOLOGY.shape[1]
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.normal(size=(B, n * S_RANK, h, D)))
                 .to(device, torch.bfloat16) for h in (H, HKV, HKV))


def rank_main(args) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.ring_attention import ring_attention
    from repro_torch.testing.subproc import join, readings

    with join(args) as world:
        mesh = make_mesh(world, TOPOLOGY.shape, TOPOLOGY.axis_names)
        n = mesh.size
        q, k, v = (t.chunk(n, dim=1)[mesh.index(TOPOLOGY.axis_names)]
                   for t in inputs(world.device))
        fn = lambda: ring_attention(q, k, v, mesh, topology=TOPOLOGY, causal=True,
                                    window=WINDOW)
        fn()                                            # warm
        with readings(mesh, world.device) as st:
            out = fn()
        torch.save({"out": out.cpu(), "stats": st}, f"{args.dir}/rank{world.rank}.pt")


def main(argv=None) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("hierarchical ring attention over a 2 x 4 topology")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    n = TOPOLOGY.shape[0] * TOPOLOGY.shape[1]
    d = run_ranks("repro_torch.examples.long_context", n, device=args.device,
                  workdir=args.dir)
    ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(n)]
    out = torch.cat([r["out"] for r in ranks], dim=1)
    q, k, v = inputs(args.device)
    want = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         causal=True, window=WINDOW).transpose(1, 2).cpu()
    err = float((out.float() - want.float()).abs().max())
    C, L = TOPOLOGY.shape
    print(f"hierarchical ring attention over {C}x{L} ranks: S={n * S_RANK}, "
          f"SWA window {WINDOW}")
    print(f"  wall {max(r['stats']['ms'] for r in ranks):.1f} ms (slowest rank, "
          f"host clock), max err vs one process {err:.2e}")
    kv_mb = 2 * S_RANK * HKV * D * 2 / 1e6
    print(f"  KV bytes rotated a rank a step: {kv_mb:.2f} MB; the cluster ring "
          f"carries only 1/{L} of the steps")
    return {"max_err": err, "ranks": [r["stats"] for r in ranks]}


if __name__ == "__main__":
    main(sys.argv[1:])
