"""Distributed check: the MoE sublayer in its ep, ep_a2a and tp modes on a
process mesh, against the one-process sublayer (the counterpart of
``repro.testing.check_moe``).

    PYTHONPATH=src python -m repro_torch.testing.check_dist_moe 2 4 --device cpu

runs 2 x 4 = 8 ranks on the CPU (gloo): qwen3-moe's smoke sublayer with 8
experts, top-2, capacity factor 8 (ep and ep_a2a) and mixtral's with
``moe_tp`` (tp) on the (data, model) mesh, the output and the gradients of
x and of every weight held to the one-process sublayer within the
reference's 2e-4; then the hierarchical all-to-all (a topology of 2 x 2 x
2 levels at 8 ranks, 2 x 2 at 4) against the one-stage exchange on the
same mesh and the flat exchange on one `model` dimension, bit for bit.

Each rank (``--rank``) draws the whole sublayer from a seeded generator on
its device, keeps its block (``sharding.shard_tree``), runs its rows and
saves its outputs in the run's directory; the launcher (:func:`main`)
puts the blocks together (``gather_tree``) and holds them to
:func:`expected`.  ``tests/test_torch_dist_moe.py`` also holds them to the
JAX package's single-device layer; ``chip_smoke.py`` runs the published
widths (``--size full``) with four ranks on one card.  Imports only the
port.
"""
from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

#: the reference's check tolerance (f32, sums in other orders)
RTOL = ATOL = 2e-4
#: each case: (arch, replaced fields, the modes it runs)
SMOKE = {"qwen3": ("qwen3-moe-235b-a22b",
                   dict(n_experts=8, experts_per_token=2, capacity_factor=8.0),
                   ("ep", "ep_a2a")),
         "mixtral": ("mixtral-8x7b", dict(moe_tp=True), ("tp",))}
#: the published widths (bf16): qwen3-moe's 128 experts of 1,536, top-8;
#: mixtral's 8 experts of 14,336, top-2, d_ff cut over `model`
FULL = {"qwen3": ("qwen3-moe-235b-a22b", {}, ("ep", "ep_a2a")),
        "mixtral": ("mixtral-8x7b", {}, ("tp",))}
#: tokens: (batch, sequence) of each size
TOKENS = {"smoke": (4, 16), "full": (4, 256)}


def case_config(name: str, size: str):
    from repro_torch.configs import get_config, get_smoke_config

    arch, over, modes = (SMOKE if size == "smoke" else FULL)[name]
    base = get_smoke_config(arch) if size == "smoke" else get_config(arch)
    return dataclasses.replace(base, **over), modes


def _defs(cfg):
    from repro_torch.models import layers as L

    return L.moe_defs_tp(cfg) if cfg.moe_tp else L.moe_defs(cfg)


def inputs(name: str, size: str, device) -> tuple:
    """(cfg, modes, whole params, x (B, S, d), cotangent (B, S, d)) of a
    case, drawn on ``device`` from fixed seeds (the same numbers on every
    rank of one device)."""
    from repro_torch.params import init_params

    cfg, modes = case_config(name, size)
    B, S = TOKENS[size]
    g = torch.Generator(device).manual_seed(1)
    params = init_params(_defs(cfg), g, device)
    x = (torch.randn((B, S, cfg.d_model), generator=g, device=device)
         * 0.3).to(cfg.dtype)
    cot = torch.randn((B, S, cfg.d_model), generator=g, device=device)
    return cfg, modes, params, x, cot


def _rows_def(cfg, B, S):
    from repro_torch.params import PV

    return PV((B, S, cfg.d_model), cfg.dtype, ("batch", "", ""))


def expected(name: str, size: str, device, grads: bool = True) -> dict:
    """The one-process sublayer: output, and (``grads``) the gradients of
    x and every weight under the cotangent."""
    from repro_torch.models import layers as L
    from repro_torch.train.trainer import trainable

    cfg, _, params, x, cot = inputs(name, size, device)
    p = trainable(params)
    xg = x.detach().requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        y = L.moe_layer(p, xg, cfg)
    out = {"y": y.detach()}
    if grads:
        names = list(p)
        gs = torch.autograd.grad((y.float() * cot).sum(), [xg] + [p[k] for k in names])
        out["dx"] = gs[0]
        out["dp"] = dict(zip(names, gs[1:]))
    return out


def _flat_rules(mesh, B):
    from repro_torch.parallel.sharding import default_rules

    return default_rules(mesh, act_seq=True, batch=B, fsdp=False)


def _level_rules(mesh):
    """The reference's hierarchical rules: every level's dimension is the
    `model` (and act_seq) axis, nothing over data."""
    from repro_torch.parallel.sharding import ShardingRules

    axes = mesh.axis_names
    return ShardingRules(mesh, {"batch": None, "seq": None, "fsdp": None,
                                "model": axes, "kv": None, "cache_seq": None,
                                "act_seq": axes})


def _run(cfg, params, x, cot, rules, grads: bool, topology=None) -> dict:
    """This rank's sublayer: its rows' output, and the gradients of its
    rows of x and of its weight blocks (summed over the data dimensions)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import block, rule_axes, shard_tree
    from repro_torch.train.trainer import trainable

    mesh = rules.mesh
    B, S, _ = x.shape
    row = _rows_def(cfg, B, S)
    spec = rules.spec(row.logical)
    x_loc = block(x, spec, mesh, mesh.rank).requires_grad_(grads)
    cot_loc = block(cot, spec, mesh, mesh.rank)
    p = trainable(shard_tree(params, _defs(cfg), rules, mesh.rank))
    with torch.set_grad_enabled(grads):
        y = L.moe_layer(p, x_loc, cfg, rules, topology=topology)
    out = {"y": y.detach().cpu()}
    if grads:
        names = list(p)
        gs = torch.autograd.grad((y.float() * cot_loc).sum(),
                                 [x_loc] + [p[k] for k in names])
        dp_axes = rule_axes(rules, "batch")
        out["dx"] = gs[0].cpu()
        out["dp"] = {k: (comm.all_reduce_raw(g, dp_axes, mesh) if dp_axes else g).cpu()
                     for k, g in zip(names, gs[1:])}
    return out


def _topology(world: int):
    """The hierarchical machine of ``world`` ranks: 2 x 2 x 2 levels (pod,
    cluster, lane) at 8, 2 x 2 (cluster, lane) at 4."""
    from repro_torch.topology import Topology

    if world == 8:
        return Topology.from_levels([("pod", 2, 8.0), ("cluster", 2, 4.0),
                                     ("lane", 2, 2.0)])
    if world == 4:
        return Topology.from_levels([("cluster", 2, 4.0), ("lane", 2, 2.0)])
    raise ValueError(f"no hierarchical topology for {world} ranks")


def rank_main(args) -> None:
    """One rank: every case's modes on the (data, model) mesh, then the
    hierarchical exchange against the flat ones; saves ``rank<r>.pt``."""
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh
    from repro_torch.models import layers as L
    from repro_torch.testing.subproc import join, readings

    with join(args) as world:
        dev = world.device
        nd, nm = args.mesh
        mesh = make_debug_mesh(world, nd, nm)
        grads = args.size == "smoke"
        res = {"mesh": (nd, nm), "modes": {}, "stats": {}}
        B, S = TOKENS[args.size]
        for name in args.cases:
            cfg, modes, params, x, cot = inputs(name, args.size, dev)
            for mode in modes:
                c = dataclasses.replace(cfg, moe_impl="a2a" if mode == "ep_a2a" else "psum")
                rules = _flat_rules(mesh, B)
                if L.moe_mode(c, rules) != mode:
                    raise AssertionError(f"{name}: mode {L.moe_mode(c, rules)}, "
                                         f"expected {mode}")
                with readings(mesh, dev) as st:
                    res["modes"][(name, mode)] = _run(c, params, x, cot, rules, grads)
                res["stats"][(name, mode)] = st
            if "ep_a2a" in modes:
                topo = _topology(world.size)
                c = dataclasses.replace(cfg, moe_impl="a2a")
                mesh_h = make_mesh(world, topo.shape, topo.axis_names)
                rules_h = _level_rules(mesh_h)
                if L.moe_mode(c, rules_h) != "ep_a2a":
                    raise AssertionError("the level rules do not give ep_a2a")
                mesh_1 = make_mesh(world, (world.size,), ("model",))
                hier = _run(c, params, x, cot, rules_h, False, topology=topo)["y"]
                one_stage = _run(c, params, x, cot, rules_h, False)["y"]
                flat_1 = _run(c, params, x, cot, _flat_rules(mesh_1, B), False)["y"]
                res["hier"] = {"name": name, "levels": topo.shape, "y": hier,
                               "same_as_one_stage": torch.equal(hier, one_stage),
                               "same_as_flat_axis": torch.equal(hier, flat_1)}
            del params, x, cot
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def assemble(d, world: int, size: str) -> dict:
    """The ranks' outputs put together: every case's whole output, x's
    gradient and weight gradients (the launcher's process, no mesh)."""
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import gather_tree

    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]
    nd, nm = ranks[0]["mesh"]
    mesh = Mesh.abstract((nd, nm), ("data", "model"))
    B, S = TOKENS[size]
    out = {}
    for key in ranks[0]["modes"]:
        name, mode = key
        cfg, _ = case_config(name, size)
        rules = _flat_rules(mesh, B)
        row = {"r": _rows_def(cfg, B, S)}
        got = {"y": gather_tree([{"r": r["modes"][key]["y"]} for r in ranks],
                                row, rules)["r"]}
        if "dx" in ranks[0]["modes"][key]:
            got["dx"] = gather_tree([{"r": r["modes"][key]["dx"]} for r in ranks],
                                    row, rules)["r"]
            got["dp"] = gather_tree([r["modes"][key]["dp"] for r in ranks],
                                    _defs(cfg), rules)
        got["stats"] = [r["stats"][key] for r in ranks]
        out[key] = got
    if "hier" in ranks[0]:
        h = ranks[0]["hier"]
        out["hier"] = {**{k: v for k, v in h.items() if k != "y"},
                       "y": torch.cat([r["hier"]["y"] for r in ranks[:1]]),
                       "all_ranks_same": all(r["hier"]["same_as_one_stage"]
                                             and r["hier"]["same_as_flat_axis"]
                                             for r in ranks)}
    return out


def compare(got: torch.Tensor, want: torch.Tensor, rtol=RTOL, atol=ATOL) -> float:
    """The largest |got - want| / (rtol |want| + atol): within at <= 1."""
    g, w = got.double().cpu(), want.double().cpu()
    return float(((g - w).abs() / (rtol * w.abs() + atol)).max())


def main(argv=None) -> dict:
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("MoE sublayer modes on a process mesh against one process")
    ap.add_argument("nd", type=int, nargs="?", default=2)
    ap.add_argument("nm", type=int, nargs="?", default=2)
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--cases", nargs="*", default=list(SMOKE))
    args = ap.parse_args(argv)
    args.mesh = (args.nd, args.nm)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    world = args.nd * args.nm
    d = run_ranks("repro_torch.testing.check_dist_moe", world, str(args.nd),
                  str(args.nm), "--size", args.size, "--cases", *args.cases,
                  device=args.device, workdir=args.dir)
    got = assemble(d, world, args.size)
    worst = 0.0
    for name in args.cases:
        want = expected(name, args.size, "cpu")
        for key in [k for k in got if k != "hier" and k[0] == name]:
            use = {"y": compare(got[key]["y"], want["y"]),
                   "dx": compare(got[key]["dx"], want["dx"]),
                   "dp": max(compare(got[key]["dp"][k], want["dp"][k])
                             for k in want["dp"])}
            worst = max(worst, *use.values())
            print(f"check_dist_moe {key[0]} {key[1]} mesh {args.nd}x{args.nm}: "
                  f"limit use {use}")
    h = got.get("hier")
    if h is not None:
        print(f"check_dist_moe hier {'x'.join(map(str, h['levels']))}: bitwise "
              f"equal to the one-stage and the flat-axis exchange on every rank: "
              f"{h['all_ranks_same']}")
    if worst > 1.0 or (h is not None and not h["all_ranks_same"]):
        raise AssertionError(f"check_dist_moe failed (limit use {worst:.3g})")
    print(f"check_dist_moe OK (mesh {args.nd}x{args.nm})")
    return got


if __name__ == "__main__":
    main(sys.argv[1:])
