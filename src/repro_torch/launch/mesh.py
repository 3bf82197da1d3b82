"""Process meshes for the distributed layers.

The port's counterpart of ``repro.launch.mesh``: ``parse_launch_topology``,
``topology_tag`` and ``production_topology`` as the reference's, and the
meshes as ``torch.distributed`` ``DeviceMesh``es (one named dimension a
topology level) wrapped in ``parallel.comm.Mesh``, which adds the groups of
several dimensions.  Every function that builds a mesh runs after
``comm.init_world``, on every rank (a ``DeviceMesh``'s groups are made
collectively); importing this module touches no process group.
"""
from __future__ import annotations

import math

from repro_torch.parallel.comm import Mesh, World
from repro_torch.topology import Level, Topology, parse_topology


def parse_launch_topology(s: str) -> Topology:
    """Parse a ``--topology`` spec onto the production dimension names:
    ``CxL[:hierarchy]`` puts clusters on `data` and lanes on `model`;
    ``PxCxL[:hierarchy]`` adds the outermost `pod` ring level."""
    n_sizes = len(s.partition(":")[0].split("x"))
    if n_sizes == 2:
        return parse_topology(s, cluster_axis="data", lane_axis="model")
    axes = ("pod", "data", "model")
    if n_sizes > 3:
        axes = tuple(f"pod{j}" for j in range(n_sizes - 3)) + axes
    return parse_topology(s, level_axes=axes)


def topology_tag(topology: Topology) -> str:
    """Short artifact tag, e.g. "topo16x4-two-level" / "topo2x8x4-flat"."""
    sizes = "x".join(str(l.size) for l in topology.levels)
    return f"topo{sizes}-{topology.hierarchy}"


def production_topology(*, multi_pod: bool = False) -> Topology:
    """The production geometry as a Topology: clusters on `data`, lanes on
    `model`; the multi-pod machine adds an outermost 2-wide `pod` level."""
    if multi_pod:
        return Topology(levels=(Level("pod", 2, 8.0), Level("data", 16, 4.0),
                                Level("model", 16, 2.0)))
    return Topology(16, 16, hierarchy="two-level",
                    cluster_axis="data", lane_axis="model")


def make_mesh(world: World, sizes, names) -> Mesh:
    """A mesh of ``sizes`` over the ranks of ``world`` (their product must
    be its size): a ``DeviceMesh`` with the named dimensions (on "cuda"
    under NCCL, else "cpu": gloo's groups hold host tensors), wrapped."""
    from torch.distributed.device_mesh import init_device_mesh

    sizes, names = tuple(sizes), tuple(names)
    if math.prod(sizes) != world.size:
        raise ValueError(f"a mesh of {sizes} needs {math.prod(sizes)} ranks, "
                         f"the world has {world.size}")
    dm = init_device_mesh("cuda" if world.backend == "nccl" else "cpu", sizes,
                          mesh_dim_names=names)
    return Mesh.from_device_mesh(dm, world.transport)


def make_production_mesh(world: World, *, multi_pod: bool = False,
                         topology: Topology | None = None) -> Mesh:
    """One mesh dimension a topology level (``production_topology`` unless
    ``topology`` is given); the topology's ranks must be the world's."""
    if topology is not None and multi_pod:
        raise ValueError("multi_pod and topology= are mutually exclusive "
                         "(use a three-level pod x cluster x lane "
                         "topology instead)")
    topo = topology or production_topology(multi_pod=multi_pod)
    names = []
    for l in topo.levels:
        if not isinstance(l.axis, str):
            raise ValueError(f"level {l.axis!r}: one mesh dimension a level")
        names.append(l.axis)
    return make_mesh(world, topo.shape, names)


def make_debug_mesh(world: World, n_data: int = 2, n_model: int = 2) -> Mesh:
    """A small (data, model) mesh for the CPU checks."""
    return make_mesh(world, (n_data, n_model), ("data", "model"))
