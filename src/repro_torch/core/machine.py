"""Machine construction (the REQI view: one program, many clusters).

The port's counterpart of ``repro.core.machine``.  ``make_machine`` is
topology-first: pass a :class:`repro_torch.topology.Topology` (say
``repro_torch.sim.araxl_params(8).topology``) and the mesh, its level grid
and the interconnect hierarchy all come from it, so the machine and the
cycle model share one geometry value (``machine.spec.topology ==
params.topology``).  The mesh has one named dimension a topology level,
outermost first; the non-lane levels ride the spec's ``cluster_axis``
tuple.  ``make_machine(C, L, hierarchy=...)`` builds the equivalent
two-level topology.

A lane is a rank: a machine of n lanes runs on the n ranks of ``world``
(``parallel.comm.init_world``), every rank calling ``make_machine`` and
then the same program.  A one-lane machine runs in the calling process
with no process group.  Registers live on the rank's card
(``world.device``, or ``device`` with no world) unless the caller asks for
the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.parallel.comm import Mesh, World
from repro_torch.topology import Topology

from .isa import AraXLMachine
from .layout import VectorMachineSpec


def _mesh(world: World | None, sizes, names) -> Mesh:
    """A mesh of ``sizes`` over the ranks of ``world``, or, with no world,
    a one-rank mesh with no process group."""
    if world is not None:
        from repro_torch.launch.mesh import make_mesh

        return make_mesh(world, sizes, names)
    if math.prod(sizes) != 1:
        raise ValueError(f"a machine of {math.prod(sizes)} lanes runs on as "
                         f"many ranks: pass world= (parallel.comm.init_world)")
    return Mesh(names, sizes)


def make_vector_mesh(n_clusters: int, n_lanes: int,
                     cluster_axis: str = "cluster", lane_axis: str = "lane",
                     world: World | None = None) -> Mesh:
    """A (C, L) mesh over the ranks of ``world`` (C * L of them)."""
    return _mesh(world, (n_clusters, n_lanes), (cluster_axis, lane_axis))


def make_topology_mesh(topology: Topology, world: World | None = None) -> Mesh:
    """One mesh dimension a topology level, outermost first."""
    names = []
    for l in topology.levels:
        if not isinstance(l.axis, str):
            raise ValueError(f"make_machine needs single-name level axes, "
                             f"got {l.axis!r}")
        names.append(l.axis)
    return _mesh(world, topology.shape, tuple(names))


def make_machine(n_clusters: int | None = None, n_lanes: int | None = None,
                 *, topology: Topology | None = None, vlen_bits: int = 65536,
                 sew_bits: int = 64, glsu_mode: str = "staged",
                 reduce_mode: str = "ring", hierarchy: str | None = None,
                 dtype=None, trace: list | None = None,
                 world: World | None = None, device: str = "cuda") -> AraXLMachine:
    """The vector machine of ``topology`` (or of a C x L grid) on the ranks
    of ``world``; every rank of it calls this, collectively.  ``device`` is
    where a machine with no world keeps its registers ("cuda" unless the
    caller asks for "cpu"); with a world, the rank's own device."""
    if topology is None:
        if n_clusters is None or n_lanes is None:
            raise ValueError("pass either topology= or (n_clusters, n_lanes)")
        # The reference's default: the flattened ring unless asked otherwise.
        topology = Topology(n_clusters, n_lanes, hierarchy=hierarchy or "flat")
    else:
        if (n_clusters, n_lanes) != (None, None) and \
                (n_clusters, n_lanes) != topology.grid:
            raise ValueError(f"(n_clusters, n_lanes)=({n_clusters}, "
                             f"{n_lanes}) conflicts with topology grid "
                             f"{topology.grid}")
        if hierarchy is not None:
            topology = topology.with_hierarchy(hierarchy)
    if world is None and device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_machine: CUDA is not available; pass "
                           "device='cpu'")
    mesh = make_topology_mesh(topology, world)
    spec = VectorMachineSpec(mesh, topology.cluster_axis, topology.lane_axis,
                             vlen_bits, sew_bits, topology=topology)
    return AraXLMachine(spec, glsu_mode=glsu_mode, reduce_mode=reduce_mode,
                        dtype=dtype or torch.float32, trace=trace,
                        device=world.device if world is not None else device)
