"""Front 2b: S1 (collective pricing coverage) and S3 (the kernel budget),
and the entry points that run the port's collectives.

The port's counterpart of ``repro.analysis.jaxpr_check``.  The reference
traces its entry points to jaxprs on 8 fake devices; the port runs each
entry point once on rank 0 of a mesh over torch's ``fake`` process group
(``launch.dryrun.fake_world``; meta or CPU tensors, no data moves) and
reads the collectives ``parallel.comm`` records (``Mesh.records``).  Every
rank runs the same program, so rank 0's records are every rank's up to
their groups, which are congruent.

S1: a collective is priced when its group's ranks form an axis-aligned
subgrid of the declared :class:`repro_torch.topology.Topology`: their
level coordinates span extents whose product is the group's size, which
``roofline.analysis.group_level_extents`` returns as they are (no flat
fallback).  A group outside the topology, or not a subgrid, is a finding.

S3: every launch plan the wrappers take at the main path's shapes (the
shapes ``testing.kernel_checks`` holds the kernels at) fits the H100's
per-block limits (``kernels.hopper``) and its split rule
(``kernels.autotune.is_legal``).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.analysis import Finding
from repro_torch.analysis.schedule_check import check_permute_records


# ---------------------------------------------------------------------------
# S1: pricing coverage
# ---------------------------------------------------------------------------

def pricing_problems(members, topology) -> list[str]:
    """Why a group of mesh positions is not priced level by level on
    ``topology`` (empty where it is)."""
    from repro_torch.roofline.analysis import group_level_extents

    members = tuple(members)
    n = topology.n_lanes
    if not members or max(members) >= n:
        return [f"group {members} reaches past the topology's {n} positions "
                f"({topology.axis_names}): priced by the flat fallback"]
    coords = [topology.coords(m) for m in members]
    extents = tuple(len({c[i] for c in coords}) for i in range(topology.n_levels))
    if math.prod(extents) != len(members) or \
            group_level_extents(members, topology) != extents:
        return [f"group of {len(members)} is not an axis-aligned subgrid of "
                f"{topology.axis_names} (extents {extents}): priced by the "
                f"flat fallback"]
    return []


def check_collective_pricing(records, topology, label: str) -> list[Finding]:
    """Every recorded collective's group prices on the topology (one
    finding a kind and group)."""
    findings, seen = [], set()
    for rec in records:
        key = (rec["kind"], tuple(rec["members"]))
        if key in seen:
            continue
        seen.add(key)
        for prob in pricing_problems(rec["members"], topology):
            findings.append(Finding(
                "S1", label, 0, f"{rec['kind']}: {prob}",
                "lay the mesh out one dimension a topology level, outermost "
                "first, and run the collective over declared levels"))
    return findings


# ---------------------------------------------------------------------------
# S3: the kernel budget
# ---------------------------------------------------------------------------

def budget_cases() -> list[tuple[str, tuple, str, dict | None]]:
    """(kernel, shape, dtype, plan) at every shape ``testing.kernel_checks``
    holds the kernels at on the main paths; plan None where it is the
    wrapper's own for the shape (paged attention's names its pool's block)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.testing import kernel_checks as kc

    dts = ("bfloat16", "float32")
    out = []
    for K, N in {**kc.MATMUL_KN, **kc.MAMBA_MATMUL_KN}.values():
        for M in kc.MATMUL_M + kc.MAMBA_ROWS + kc.MOE_M:
            out += [("matmul", (M, K, N), dt, None) for dt in dts]
        T = kc.TRAIN_TOKENS
        out += [("matmul", (T, N, K, 1), "bfloat16", None),
                ("matmul", (K, T, N, 2), "bfloat16", None)]
    out += [("matmul", (M, K, N), str(dt).replace("torch.", ""), None)
            for M, K, N, dt in kc.MATMUL_RAGGED]
    for B, S, _ in kc.FLASH_CASES:
        out += [("flash_attention", (B, kc.HQ, kc.HKV, S, S, kc.HEAD_DIM), dt, None)
                for dt in dts]
    for _, lens, G, D, bt, _ in kc.PAGED_CASES:
        B, T = len(lens), kc.PAGED_NBLK * bt
        plan = {"bt": bt, "splits": pa.plan(B, kc.HKV, G, T).splits}
        out += [("paged_attention", (B, kc.HKV * G, kc.HKV, T, D), dt, plan)
                for dt in dts]
    out += [("rmsnorm", (R, kc.D_MODEL), dt, None) for R in kc.RMSNORM_R for dt in dts]
    for cfg in kc.TABLE1.values():
        out.append(("reduction", (cfg["dot"],), "float32", None))
        out.append(("stencil", tuple(cfg["jacobi"]), "float32", None))
    return out


def check_kernel_budget(cases=None) -> list[Finding]:
    """The wrappers' plan at each case is legal on the card."""
    from repro_torch.kernels import autotune as at

    findings = []
    for kernel, shape, dtype, plan in (budget_cases() if cases is None else cases):
        cfg = plan or at.default_config(kernel, shape, dtype)
        if not at.is_legal(kernel, shape, dtype, cfg):
            r = at.block_resources(kernel, shape, dtype, cfg)
            findings.append(Finding(
                "S3", f"plan:{kernel}{list(shape)}:{dtype}", 0,
                f"plan {cfg} ({r['smem']} B of shared memory, {r['threads']} "
                f"threads a block) exceeds the H100's limits or its split rule",
                "shrink the tile or the slices (kernels/hopper.py has the "
                "limits)"))
    return findings


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Entry:
    label: str
    records: list
    topology: object             # the declared Topology


def _records(mesh, fn) -> list:
    mesh.records = []
    fn()
    return list(mesh.records)


def _model_entries() -> list[Entry]:
    """The train, prefill and decode steps of the llama3-8b smoke model on
    (data 2, model 2), and the MoE sublayer's token all-to-all (qwen3-moe
    smoke, ``moe_impl="a2a"``) on (pod 2, data 2, model 2)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.topology import Level, Topology

    out = []
    topo = Topology(2, 2, hierarchy="two-level", cluster_axis="data",
                    lane_axis="model")
    cfg = get_smoke_config("llama3-8b")
    with dr.fake_world(4):
        mesh = dr.fake_mesh((2, 2), ("data", "model"))
        for kind in ("train", "prefill", "decode"):
            rec = dr.run_cell(cfg, ShapeSpec(kind, 64, 4, kind), mesh)
            out.append(Entry(f"entry:{kind}[llama3-8b smoke,2x2]", rec["records"], topo))
    topo3 = Topology(levels=(Level("pod", 2, 8.0), Level("data", 2, 4.0),
                             Level("model", 2, 2.0)))
    moe = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), moe_impl="a2a")
    with dr.fake_world(8):
        mesh = dr.fake_mesh((2, 2, 2), ("pod", "data", "model"))
        rec = dr.run_cell(moe, ShapeSpec("train", 32, 8, "train"), mesh)
        out.append(Entry("entry:moe_a2a[qwen3-moe smoke,2x2x2]", rec["records"], topo3))
    return out


def _ring_entries() -> list[Entry]:
    """The machine's ring collectives (``core.ring``) on (cluster 2, lane
    4), flat and two-level, seq and db, and ring attention hierarchical on
    (pod, cluster, lane) = (2, 2, 2) and flat on 8 lanes."""
    import torch

    from repro_torch.core import ring
    from repro_torch.core.layout import VectorMachineSpec
    from repro_torch.launch import dryrun as dr
    from repro_torch.parallel.ring_attention import ring_attention
    from repro_torch.topology import Topology

    out = []
    with dr.fake_world(8):
        mesh = dr.fake_mesh((2, 4), ("cluster", "lane"))
        for h in ("flat", "two-level"):
            topo = Topology(2, 4, hierarchy=h, cluster_axis="cluster", lane_axis="lane")
            spec = VectorMachineSpec(mesh, "cluster", "lane", topology=topo)
            col = torch.zeros(16, dtype=torch.float64)
            out.append(Entry(f"entry:reduce_scalar[{h}]", _records(
                mesh, lambda: ring.reduce_scalar(spec, col, "sum")), topo))
            for s in ("seq", "db"):
                out.append(Entry(f"entry:ring_allgather[{h},{s}]", _records(
                    mesh, lambda: ring.ring_allgather(spec, torch.zeros(8),
                                                      schedule=s)), topo))
                out.append(Entry(f"entry:ring_reduce_scatter[{h},{s}]", _records(
                    mesh, lambda: ring.ring_reduce_scatter(spec, torch.zeros(16),
                                                           schedule=s)), topo))
    q = torch.zeros(1, 16, 2, 8)
    with dr.fake_world(8):
        mesh = dr.fake_mesh((2, 2, 2), ("pod", "cluster", "lane"))
        topo3 = Topology.from_levels([("pod", 2, 8.0), ("cluster", 2, 4.0),
                                      ("lane", 2, 2.0)])
        for s in ("seq", "db"):
            out.append(Entry(f"entry:ring_attention[hier2x2x2,{s}]", _records(
                mesh, lambda: ring_attention(q, q, q, mesh, topology=topo3,
                                             schedule=s)), topo3))
    with dr.fake_world(8):
        mesh = dr.fake_mesh((8,), ("lane",))
        topo1 = Topology.from_levels([("lane", 8, 2.0)])
        for s in ("seq", "db"):
            out.append(Entry(f"entry:ring_attention[flat,{s}]", _records(
                mesh, lambda: ring_attention(q, q, q, mesh, axis="lane",
                                             schedule=s)), topo1))
    return out


def entries() -> list[Entry]:
    return _model_entries() + _ring_entries()


def semantic_findings() -> list[Finding]:
    """Run every entry point and check S1 and S2 on its records, then S3."""
    findings: list[Finding] = []
    for e in entries():
        if not e.records:
            findings.append(Finding("S1", e.label, 0, "no collective recorded",
                                    "the entry point did not run on its mesh"))
        findings += check_collective_pricing(e.records, e.topology, e.label)
        findings += check_permute_records(e.records, e.label)
    findings += check_kernel_budget()
    return findings
