"""Dry run of a cell: one rank's step on ``meta`` tensors, counted.

The port's counterpart of ``repro.launch.dryrun``.  The reference lowers
and compiles each (arch x shape x mesh) cell on 512 fake XLA devices and
reads the compiled module's memory, cost and collectives.  The port has no
compiler to ask, so one process plays rank 0 of the cell's mesh and runs
the step itself (:func:`run_cell`):

* the process group is torch's ``fake`` backend (``FakeStore``: every
  collective returns at once and moves nothing), set up by
  :func:`fake_world` before the mesh is made, as the reference sets its
  ``XLA_FLAGS`` first; it is the dry run's own and never the program's
  (``parallel.comm.layout`` gives only gloo and NCCL);
* the state and the inputs are ``meta`` tensors at rank 0's block shapes
  (``launch.specs``), so nothing is allocated and the kernels' wrappers
  take their plain versions (``kernels.launches.PLAIN_DEVICES``);
* the train step, the prefill or the decode step runs once under
  ``torch.utils.flop_counter.FlopCounterMode`` (FLOPs) and
  :class:`OpBytes` (each op's tensor inputs and outputs: the unfused upper
  bound of the bytes, as the reference's count on its CPU module is);
* its collectives are what ``parallel.comm`` records (``Mesh.records``),
  priced by ``roofline.analysis`` per topology level.

Torch runs every period eagerly, so no 1-/2-period extrapolation is
needed.  A microbatched train step is counted as the reference counts it:
one microbatch's step (``n_micro=1`` at the microbatch's shape) times the
microbatches.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --topology 32x8:two-level
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import archs, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import (parse_launch_topology, production_topology,
                                     topology_tag)
from repro_torch.launch.specs import (SHAPES, ShapeSpec, input_specs, meta_tree,
                                      skip_reason, tree_bytes)
from repro_torch.models import lm
from repro_torch.parallel.comm import Mesh
from repro_torch.parallel.sharding import ShardingRules, default_rules
from repro_torch.roofline.analysis import (HW, collective_bytes,
                                           collective_level_bytes,
                                           exposed_level_seconds,
                                           level_wire_seconds, memory_model_bytes,
                                           resident_model_bytes, roofline_terms,
                                           wire_seconds)
from repro_torch.testing.timing import now
from repro_torch.topology import Topology
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import (TrainState, make_train_step, trainable,
                                       train_state_defs)

#: memory-bound giants keep m/v and the gradient accumulators in bf16 (the
#: reference's choice)
OPT_BF16 = {"qwen3-moe-235b-a22b", "jamba-1.5-large-398b"}
#: target local microbatch (sequences a device an accumulation step)
TARGET_LOCAL_MB = 2
LOSS_CHUNK = 512
#: one card's memory, the fit criterion of a record
HBM_BYTES = 80 * 2 ** 30


def _dp_size(mesh: Mesh | None) -> int:
    if mesh is None:
        return 1
    return math.prod(mesh.shape.get(a, 1) for a in ("pod", "data"))


def n_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh | None) -> int:
    if shape.kind != "train":
        return 1
    local = max(1, shape.global_batch // _dp_size(mesh))
    n = max(1, local // TARGET_LOCAL_MB)
    while shape.global_batch % n:
        n -= 1
    return n


def build_rules(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh | None) -> ShardingRules:
    return default_rules(mesh, kv_heads=cfg.n_kv_heads,
                         cache_seq="model" if shape.is_decode else None,
                         act_seq=not shape.is_decode, batch=shape.global_batch)


def opt_config(cfg: ModelConfig) -> OptConfig:
    if cfg.name in OPT_BF16:
        return OptConfig(state_dtype=torch.bfloat16, master_fp32=False,
                         math_dtype=torch.bfloat16)
    return OptConfig()


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch          # one token


# ---------------------------------------------------------------------------
# the fake process group and the counting modes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """A process group of ``size`` ranks on torch's ``fake`` backend, this
    process rank 0, for the extent of the block (nothing if size is 1).  A
    process that already has a process group is refused: the dry run's
    group is its own."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if size <= 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a process "
                           "group is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(sizes, names) -> Mesh:
    """Rank 0 of a mesh over the fake process group, recording every
    collective (``Mesh.records``); ``direct`` transport, so no tensor is
    copied through the host."""
    mesh = Mesh(names, sizes, rank=0, transport="direct")
    mesh.records = []
    return mesh


def topology_mesh(topology: Topology) -> tuple[tuple, tuple]:
    """(sizes, names) of the mesh a topology lays out: one dimension a
    level, outermost first."""
    names = tuple(a for lvl in topology.levels for a in lvl.axes)
    if len(names) != topology.n_levels:
        raise ValueError(f"a level of {topology.describe()} names several "
                         f"dimensions; the dry run lays one out a level")
    return tuple(lvl.size for lvl in topology.levels), names


#: ops that move no bytes: they allocate, or alias their input
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "detach",
             "lift_fresh", "alias"}


class OpBytes(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs (views and
    allocations excluded, collectives left to the wire count): what the
    step reads and writes if no op were fused with another."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if func.namespace in ("c10d", "_c10d_functional") or func.is_view \
                or name in _NO_BYTES:
            return out
        leaves = tree_flatten((args, kwargs or {}, out))[0]
        self.bytes += sum(t.numel() * t.element_size() for t in leaves
                          if isinstance(t, torch.Tensor))
        return out


def _matmul_flops(counts: dict) -> float:
    return float(sum(v for k, v in counts.items()
                     if str(k).split(".")[-1] in ("mm", "addmm", "bmm", "baddbmm")))


def run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh | None, *,
             rules: ShardingRules | None = None, n_micro: int = 1,
             grad_sync=None) -> dict:
    """One step of the cell on rank 0 of ``mesh`` (None: one device), on
    meta tensors: ``flops`` (all, and ``matmul_flops`` of the products),
    ``bytes`` (:class:`OpBytes`), ``records`` (the collectives), and
    ``arg_bytes`` (the state and the inputs a rank holds)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(cfg, loss_chunk=LOSS_CHUNK)
    rules = rules if rules is not None else build_rules(cfg, shape, mesh)
    if mesh is not None:
        mesh.records = []
    batch = input_specs(cfg, shape, rules)
    on_mesh = rules if rules.mesh is not None else None
    params = meta_tree(lm.model_defs(cfg), rules)
    if shape.kind == "train":
        ocfg = opt_config(cfg)
        pdefs, odefs = train_state_defs(cfg, ocfg)
        state = TrainState(trainable(params), meta_tree(odefs, rules))
        acc = torch.bfloat16 if cfg.name in OPT_BF16 else torch.float32
        step = make_train_step(cfg, ocfg, n_microbatches=n_micro, acc_dtype=acc,
                               rules=on_mesh, grad_sync=grad_sync)
        args = (state.params, state.opt, batch)
        run = lambda: step(state, batch)
    elif shape.kind == "prefill":
        args = (params, batch)
        run = lambda: lm.prefill(params, batch["tokens"], cfg, shape.seq_len,
                                 batch.get("ctx"), rules=on_mesh)
    else:
        args = (params, batch)
        # the position a host int, as the engines pass it (the cache's last
        # slot); ``batch["pos"]`` stands for it among the arguments
        run = lambda: lm.decode_step(params, batch["token"], batch["cache"],
                                     shape.seq_len - 1, cfg, rules=on_mesh)
    ops = OpBytes()
    with FlopCounterMode(display=False) as fc, ops:
        if shape.kind == "train":
            run()
        else:
            with torch.no_grad():
                run()
    counts = fc.get_flop_counts().get("Global", {})
    return {"flops": float(fc.get_total_flops()),
            "matmul_flops": _matmul_flops(counts),
            "bytes": float(ops.bytes),
            "records": list(mesh.records) if mesh is not None else [],
            "arg_bytes": tree_bytes(args)}


def analyse_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh | None,
                 mesh_name: str, *, topology: Topology | None = None,
                 rules: ShardingRules | None = None, n_micro: int | None = None,
                 grad_sync=None) -> dict:
    """Run one cell (:func:`run_cell`) and derive its roofline record, with
    the reference's keys.  ``topology`` prices the collectives per level;
    ``rules`` / ``n_micro`` / ``grad_sync`` are a strategy's overrides
    (``launch.perf``)."""
    n_dev = 1 if mesh is None else mesh.size
    t0 = now()
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
           "devices": int(n_dev), "kind": shape.kind}
    if topology is not None:
        rec["topology"] = topology.describe()
    nm = n_micro if n_micro is not None else n_microbatches(cfg, shape, mesh)
    rec["n_microbatches"] = nm

    cshape = shape if nm == 1 else dataclasses.replace(
        shape, global_batch=shape.global_batch // nm)
    one = run_cell(cfg, cshape, mesh, rules=rules, n_micro=1, grad_sync=grad_sync)
    # the step's arguments hold every microbatch's rows
    rules_ = rules if rules is not None else build_rules(cfg, shape, mesh)
    args_bytes = one["arg_bytes"] + tree_bytes(input_specs(cfg, shape, rules_)) \
        - tree_bytes(input_specs(cfg, cshape, rules_))
    resident = resident_model_bytes(cfg, shape, n_dev, nm, args_bytes,
                                    topology=topology)
    rec["mem_per_device"] = {
        "arguments_gib": args_bytes / 2 ** 30,
        # the step updates its state (and a decode step its cache) in place
        "outputs_gib": 0.0,
        "aliased_gib": 0.0,
        # the eager step's temporaries are not traced: residency is the
        # analytic model over the exact arguments
        "temps_gib": None,
        "peak_gib": resident / 2 ** 30,
        "total_gib": resident / 2 ** 30,
        "resident_model_gib": resident / 2 ** 30,
    }
    rec["fits_80gib_hbm"] = bool(resident < HBM_BYTES)
    rec["compile_s_full"] = round(now() - t0, 1)

    flops = nm * one["flops"]
    bytes_ = nm * one["bytes"]
    wire = collective_bytes(one["records"])
    wire_total = nm * wire["total"]
    rec["per_device"] = {"flops": flops, "matmul_flops": nm * one["matmul_flops"],
                         "bytes": bytes_, "wire_bytes": wire_total}
    rec["collectives"] = {k: nm * v for k, v in wire.items()}
    coll_s = None
    if topology is not None:
        levels = collective_level_bytes(one["records"], topology)
        wire_by_level = {lab: nm * levels[lab] for lab in topology.wire_labels()}
        secs = level_wire_seconds(wire_by_level, topology)
        coll_s = secs.pop("total")
        rec["per_device"]["wire_bytes_by_level"] = wire_by_level
    rec["roofline"] = roofline_terms(flops, bytes_, wire_total, collective_s=coll_s)
    if topology is not None:
        rec["roofline"]["collective_s_by_level"] = secs
        rec["roofline"]["collective_s_flat_hw"] = wire_seconds(wire_total)
    # the analytic traffic model is the memory term; the op count, which no
    # fusion reduces, its upper bound
    mm = memory_model_bytes(cfg, shape, n_dev, nm, topology=topology)
    rec["roofline"]["memory_s_hlo_upper"] = rec["roofline"]["memory_s"]
    rec["roofline"]["memory_s"] = mm / HW["hbm_bw"]
    terms = {k: rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s")}
    rec["roofline"]["bottleneck"] = max(terms, key=terms.get)
    rec["roofline"]["step_s_lower_bound"] = max(terms.values())
    if topology is not None:
        exp = exposed_level_seconds(rec["roofline"]["collective_s_by_level"],
                                    terms["compute_s"], topology)
        rec["roofline"]["exposed_collective_s"] = exp.pop("total")
        rec["roofline"]["exposed_collective_s_by_level"] = exp
        rec["roofline"]["step_s_overlap_aware"] = max(
            terms["memory_s"], terms["compute_s"] + rec["roofline"]["exposed_collective_s"])
    mf = model_flops(cfg, shape)
    rec["model_flops_global"] = mf
    traced_global = flops * n_dev
    rec["model_vs_hlo_flops"] = mf / traced_global if traced_global else 0.0
    bound = rec["roofline"]["step_s_lower_bound"]
    rec["roofline"]["mfu_upper_bound"] = (mf / n_dev / HW["peak_flops"] / bound
                                          if bound else 0.0)
    rec["elapsed_s"] = round(now() - t0, 1)
    return rec


def analyse(cfg: ModelConfig, shape: ShapeSpec, topology: Topology | None,
            mesh_name: str, *, strategy=None) -> dict:
    """:func:`analyse_cell` on rank 0 of the topology's mesh over a fake
    process group of its size (one device where ``topology`` is None).
    ``strategy(cfg, shape, mesh) -> (cfg, rules, n_micro, grad_sync)``
    gives a strategy's overrides, made on the mesh (``launch.perf``)."""
    if topology is None:
        return analyse_cell(cfg, shape, None, mesh_name)
    sizes, names = topology_mesh(topology)
    with fake_world(math.prod(sizes)):
        mesh = fake_mesh(sizes, names)
        rules = n_micro = grad_sync = None
        if strategy is not None:
            cfg, rules, n_micro, grad_sync = strategy(cfg, shape, mesh)
        return analyse_cell(cfg, shape, mesh, mesh_name, topology=topology,
                            rules=rules, n_micro=n_micro, grad_sync=grad_sync)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--topology", default=None, metavar="[P x]CxL[:hierarchy]",
                    help="replace the pod mesh with an explicit topology "
                         "(clusters on `data`, lanes on `model`; a third leading "
                         "size adds the `pod` level, e.g. 2x16x8:three-level)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    names = args.arch or (sorted(archs.CONFIGS) if args.all else ["llama3-8b"])
    shapes = args.shape or list(SHAPES)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.topology is not None:
        if args.mesh != "single":
            ap.error("--topology replaces the pod mesh entirely; drop --mesh")
        topo = parse_launch_topology(args.topology)
        plan = [(topology_tag(topo), topo)]
    else:
        plan = [("pod2x16x16" if m else "pod16x16", production_topology(multi_pod=m))
                for m in {"single": [False], "multi": [True],
                          "both": [False, True]}[args.mesh]]
    failures = []
    for mname, topo in plan:
        for arch in names:
            cfg = get_config(arch)
            for sname in shapes:
                path = outdir / f"{arch}__{sname}__{mname}.json"
                why = skip_reason(cfg, sname)
                if why:
                    path.write_text(json.dumps({"arch": arch, "shape": sname,
                                                "mesh": mname, "skipped": why},
                                               indent=2))
                    print(f"[skip] {arch} x {sname} ({why})")
                    continue
                if path.exists():
                    print(f"[cached] {path}")
                    continue
                try:
                    rec = analyse(cfg, SHAPES[sname], topo, mname)
                    path.write_text(json.dumps(rec, indent=2))
                    r = rec["roofline"]
                    print(f"[ok] {arch} x {sname} x {mname}: "
                          f"resident={rec['mem_per_device']['resident_model_gib']:.2f}GiB "
                          f"compute={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s bound={r['bottleneck']} "
                          f"({rec['elapsed_s']}s)", flush=True)
                except Exception as e:          # keep sweeping; failures exit 1
                    failures.append((arch, sname, mname, repr(e)))
                    print(f"[FAIL] {arch} x {sname} x {mname}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("\nall requested dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
