"""Distributed long-vector register layouts (AraXL §III-B.2).

AraXL maps memory element ``i`` of a vector register to

    cluster  (i // L) mod C        (C clusters)
    lane      i mod L              (L lanes per cluster)
    row       i // (C*L)           (depth inside the lane's VRF chunk)

a *striped* layout (block-cyclic with block 1 over lanes, block L over
clusters), which keeps mixed-width operations lane-local and feeds every
FPU from unit-stride memory streams.  The port's counterpart of
``repro.core.layout``: a lane is a rank of a process mesh
(``parallel.comm.Mesh``), and a register's ``data`` is this rank's (B,)
column, the rows ``b`` of elements ``i = b*n + p`` at ring position ``p``
(``p = c*L + l``, the flattened outer-major coordinate over the ring axes).
That column is the local block a JAX device holds of the (B, C, L) global
array under ``shard_map``; assembled over the ranks in ring order it is
that global array.

``VectorLayout.BLOCKED`` is the reference's alternative (element ``i`` on
flat position ``i // B``); its index maps are kept, the ISA runs striped.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from repro_torch.parallel.comm import Mesh
from repro_torch.topology import Topology

Axis = str | tuple[str, ...]


class VectorLayout(enum.Enum):
    STRIPED = "striped"   # paper-faithful AraXL byte map
    BLOCKED = "blocked"   # contiguous per-position blocks


def _axis_tuple(axis: Axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True)
class VectorMachineSpec:
    """Static geometry of the distributed vector machine over a process mesh.

    ``cluster_axis`` plays AraXL's inter-cluster role (a tuple of every
    non-lane level on a deeper topology), ``lane_axis`` the intra-cluster
    lanes.  ``topology`` is the shared :class:`repro_torch.topology.Topology`
    (the value ``repro_torch.sim.AraXLParams.topology`` exposes); when
    omitted it is the mesh's flat two-level geometry, and when given its
    grid must match the mesh's sizes.
    """

    mesh: Mesh
    cluster_axis: Axis = "cluster"
    lane_axis: Axis = "lane"
    vlen_bits: int = 65536          # RVV-maximum 64 Kibit / vreg (the paper's flagship)
    sew_bits: int = 64              # DP elements, as evaluated in the paper
    topology: Topology | None = None

    def __post_init__(self):
        if self.topology is None:
            object.__setattr__(self, "topology", Topology(
                self.n_clusters, self.n_lanes, hierarchy="flat",
                cluster_axis=self.cluster_axis, lane_axis=self.lane_axis))
        elif self.topology.grid != (self.n_clusters, self.n_lanes):
            raise ValueError(
                f"topology grid {self.topology.grid} does not match the mesh "
                f"axis sizes ({self.n_clusters}, {self.n_lanes})")

    @property
    def n_clusters(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.cluster_axes)

    @property
    def n_lanes(self) -> int:
        """Lanes per cluster."""
        return math.prod(self.mesh.shape[a] for a in self.lane_axes)

    @property
    def n_total_lanes(self) -> int:
        return self.n_clusters * self.n_lanes

    @property
    def vlen_elems(self) -> int:
        return self.vlen_bits // self.sew_bits

    @property
    def cluster_axes(self) -> tuple[str, ...]:
        """The inter-cluster ring axes (hierarchy level 2) as a tuple."""
        return _axis_tuple(self.cluster_axis)

    @property
    def lane_axes(self) -> tuple[str, ...]:
        """The intra-cluster lane axes (hierarchy level 1) as a tuple."""
        return _axis_tuple(self.lane_axis)

    def topology_levels(self) -> tuple:
        """Per-level (mesh-axes tuple, size) pairs, outermost first: what the
        hierarchical collectives of ``core.ring`` and ``core.glsu`` walk."""
        return tuple((_axis_tuple(l.axis), l.size)
                     for l in self.topology.levels)

    @property
    def ring_axes(self) -> tuple[str, ...]:
        """The flattened (cluster-major, lane-minor) ring over every lane:
        position ``p = c * L + l`` matches the element striping, so a
        slide by 1 is one neighbour hop."""
        return self.cluster_axes + self.lane_axes

    @property
    def ring_pos(self) -> int:
        """This rank's position on the flattened ring."""
        return self.mesh.index(self.ring_axes)

    def padded_vl(self, vl: int) -> int:
        lanes = self.n_total_lanes
        return ((vl + lanes - 1) // lanes) * lanes


# ---------------------------------------------------------------------------
# Pure index maps (the paper's byte-mapping equations): the oracles of the
# tests and of the GLSU.
# ---------------------------------------------------------------------------

def element_to_coords(i: int | np.ndarray, C: int, L: int):
    """AraXL: element-i -> (row b, cluster c, lane l)."""
    b = i // (C * L)
    c = (i // L) % C
    l = i % L
    return b, c, l


def coords_to_element(b, c, l, C: int, L: int):
    return b * (C * L) + c * L + l


def mem_to_striped_host(x: np.ndarray, C: int, L: int) -> np.ndarray:
    """Reference (host) GLSU mapping: 1-D memory vector -> (B, C, L)."""
    assert x.ndim == 1 and x.shape[0] % (C * L) == 0
    return x.reshape(-1, C, L)


def striped_to_mem_host(reg: np.ndarray) -> np.ndarray:
    return reg.reshape(-1)


# ---------------------------------------------------------------------------
# Register-file containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VReg:
    """A distributed vector register: ``data`` is this rank's (B,) column,
    ``vl`` the live vector length (<= B * n); the tail is architectural
    zero (RVV tail-agnostic, the reference picks tail-zero)."""

    data: torch.Tensor
    vl: int
    layout: VectorLayout = VectorLayout.STRIPED

    def astype(self, dtype) -> "VReg":
        return VReg(self.data.to(dtype), self.vl, self.layout)


def vreg_zeros(spec: VectorMachineSpec, vl: int, dtype=torch.float32,
               layout: VectorLayout = VectorLayout.STRIPED,
               device="cpu") -> VReg:
    B = spec.padded_vl(vl) // spec.n_total_lanes
    return VReg(torch.zeros(B, dtype=dtype, device=device), vl, layout)


def global_index_grid(spec: VectorMachineSpec, B: int,
                      layout: VectorLayout = VectorLayout.STRIPED,
                      device="cpu") -> torch.Tensor:
    """The logical element index held at each row of this rank's column."""
    b = torch.arange(B, device=device)
    p = spec.ring_pos
    if layout is VectorLayout.STRIPED:
        return b * spec.n_total_lanes + p
    return p * B + b


def valid_mask(spec: VectorMachineSpec, vreg: VReg) -> torch.Tensor:
    """Boolean mask of this rank's rows holding an element ``i < vl``, in
    the data's layout (the MASKU byte-encoding insight: a mask is consumed
    where it lies, with no cross-lane movement)."""
    idx = global_index_grid(spec, vreg.data.shape[0], vreg.layout,
                            vreg.data.device)
    return idx < vreg.vl
