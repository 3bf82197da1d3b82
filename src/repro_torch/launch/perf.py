"""Performance strategies of a cell: hypothesis -> change -> re-run the dry
run -> re-read its roofline.

The port's counterpart of ``repro.launch.perf``.  Each named strategy is
one change against the baseline, given to ``dryrun.analyse_cell`` as its
plain overrides (``rules=``, ``n_micro=``, ``grad_sync=``), so before and
after are records of the same shape:

  baseline      the dry run's configuration (tensor-parallel over `model`,
                ZeRO-3 and sequence-parallel)
  fsdp_pure     no tensor parallelism: parameters and batch over every
                mesh dimension (ZeRO-3 / pure data parallelism)
  fsdp_hier     the ZeRO-3 dimension only over the inner topology levels
                (replicated across the outermost), the gradients summed by
                the train step's sync (``trainer.make_grad_sync``)
  fsdp_hier_ov  fsdp_hier with the bucketed sync issued during the
                backward (``make_grad_sync(bucket_mb=GRAD_BUCKET_MB)``)
  moe_a2a       token all-to-all expert parallelism (``moe_impl="a2a"``)
                in place of the replicated-token combine
  nm_half/nm1   fewer, larger microbatches

    PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3-8b --shape train_4k --strategy baseline --strategy fsdp_pure
    PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3-8b --shape train_4k --mesh multi --strategy fsdp_pure --strategy fsdp_hier
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import traceback

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import (parse_launch_topology, production_topology,
                                     topology_tag)
from repro_torch.launch.specs import SHAPES
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.topology import Topology
from repro_torch.train.trainer import make_grad_sync

#: the bucket size of fsdp_hier_ov's backward-issued gradient sync
GRAD_BUCKET_MB = 25.0
STRATEGIES = ("baseline", "fsdp_pure", "fsdp_hier", "fsdp_hier_ov", "moe_a2a",
              "nm_half", "nm1")


def _all_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.shape)


def _fsdp_pure_rules(mesh, cfg, shape) -> ShardingRules:
    """batch and fsdp over every mesh dimension; no tensor parallelism."""
    all_axes = _all_axes(mesh)
    rules = {
        "batch": all_axes if shape.global_batch % mesh.axis_size(all_axes) == 0
        else tuple(a for a in ("pod", "data") if a in mesh.shape),
        "seq": None,
        "fsdp": all_axes,
        "model": None,
        "kv": None,
        "cache_seq": "model" if shape.is_decode else None,
        "act_seq": None,
    }
    return ShardingRules(mesh, rules)


def _fsdp_hier_rules(mesh, cfg, shape, topology: Topology) -> ShardingRules:
    """fsdp_pure with the parameters cut over the inner topology levels
    only (each outermost group holds a whole replica); every other rule is
    fsdp_pure's, so the two differ in the gradient sync alone."""
    inner = tuple(a for lvl in topology.levels[1:] for a in lvl.axes
                  if a in mesh.shape) or _all_axes(mesh)
    base = _fsdp_pure_rules(mesh, cfg, shape)
    return ShardingRules(mesh, {**base.rules, "fsdp": inner})


def apply_strategy(strategy: str, cfg, shape, mesh, topology: Topology):
    """Returns (cfg', rules_override, n_micro_override, grad_sync)."""
    if strategy == "baseline":
        return cfg, None, None, None
    if strategy == "fsdp_pure":
        return cfg, _fsdp_pure_rules(mesh, cfg, shape), 1, None
    if strategy == "fsdp_hier":
        rules = _fsdp_hier_rules(mesh, cfg, shape, topology)
        return cfg, rules, 1, make_grad_sync(cfg, rules)
    if strategy == "fsdp_hier_ov":
        rules = _fsdp_hier_rules(mesh, cfg, shape, topology)
        return cfg, rules, 1, make_grad_sync(cfg, rules, bucket_mb=GRAD_BUCKET_MB)
    if strategy == "moe_a2a":
        return dataclasses.replace(cfg, moe_impl="a2a"), None, None, None
    if strategy == "nm_half":
        return cfg, None, max(1, dr.n_microbatches(cfg, shape, mesh) // 2), None
    if strategy == "nm1":
        return cfg, None, 1, None
    raise ValueError(strategy)


def analyse(arch: str, shape_name: str, strategy: str, multi: bool = False,
            topology: Topology | None = None, smoke: bool = False) -> dict:
    """One cell under one strategy: the dry run's record, tagged."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    topo = topology if topology is not None else production_topology(multi_pod=multi)
    mname = (topology_tag(topo) if topology is not None else
             "pod2x16x16" if multi else "pod16x16")
    rec = dr.analyse(cfg, shape, topo, mname,
                     strategy=lambda c, s, m: apply_strategy(strategy, c, s, m, topo))
    rec["strategy"] = strategy
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--strategy", action="append", required=True, choices=STRATEGIES)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single",
                    help="production pod mesh (multi = the three-level 2x16x16)")
    ap.add_argument("--topology", default=None, metavar="[P x]CxL[:hierarchy]",
                    help="replace the mesh with an explicit topology")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config (records tagged __smoke)")
    ap.add_argument("--out", default="results/perf_torch")
    args = ap.parse_args(argv)
    if args.topology is not None and args.mesh != "single":
        ap.error("--topology replaces the pod mesh entirely; drop --mesh")
    topo = parse_launch_topology(args.topology) if args.topology else None
    tsuffix = f"__{topology_tag(topo)}" if topo is not None else \
        ("__pod2x16x16" if args.mesh == "multi" else "")
    if args.smoke:
        tsuffix += "__smoke"
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failures = []
    for strat in args.strategy:
        path = out / f"{args.arch}__{args.shape}__{strat}{tsuffix}.json"
        if path.exists():
            print(f"[cached] {path}")
            continue
        try:
            rec = analyse(args.arch, args.shape, strat, multi=args.mesh == "multi",
                          topology=topo, smoke=args.smoke)
            path.write_text(json.dumps(rec, indent=2))
            r = rec["roofline"]
            lv = " ".join(f"{k}={v:.4f}s" for k, v in
                          r.get("collective_s_by_level", {}).items())
            print(f"[ok] {args.arch} x {args.shape} x {strat}: "
                  f"compute={r['compute_s']:.3f}s mem={r['memory_s']:.3f}s "
                  f"coll={r['collective_s']:.3f}s [{lv}] bound={r['bottleneck']} "
                  f"mfu_ub={r['mfu_upper_bound']:.3f} "
                  f"res={rec['mem_per_device']['resident_model_gib']:.1f}GiB", flush=True)
        except Exception as e:          # keep sweeping: later strategies still run
            failures.append(strat)
            print(f"[FAIL] {strat}: {e}")
            traceback.print_exc()
    if failures:
        print(f"{len(failures)} strategy failures: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
