"""Topology: the machine geometry as levels of rings (pods of clusters of
lanes), outermost first.

The port's copy of the geometry part of ``repro.topology``: ``Level``,
``Topology`` (its constructors, ``n_levels``, ``shape``, ``axis_names``,
``strides``, ``coords``), ``check_hierarchy``, ``mesh_levels`` and
``parse_topology``.  The distributed layers read a topology's levels as
the named dimensions of a process mesh: the hierarchical MoE all-to-all
runs one stage a level, innermost first, and ring attention's KV rotation
walks the levels as an odometer.  The pricing methods (hop latencies, wire
bandwidths, slides) are not copied.  Pure Python, no torch.
"""
from __future__ import annotations

import dataclasses
import math

#: "<n>-level" spellings for the common depths (hier_name falls back to
#: the numeric form for anything deeper)
_HIER_WORDS = {1: "one-level", 2: "two-level", 3: "three-level",
               4: "four-level", 5: "five-level"}

#: default per-level axis names for parse_topology("PxCxL") style specs,
#: innermost last; levels beyond the pod are named by their depth from the
#: innermost (lane=1, cluster=2, pod=3): "l4", "l5", ...
DEFAULT_LEVEL_AXES = ("pod", "cluster", "lane")


def default_hop_lat(depth_from_inner: int) -> float:
    """The per-hop wire price of level j counted from the innermost
    outward: 2, 4, 8, ... cycles."""
    return 2.0 * (2 ** depth_from_inner)


def hier_name(n_levels: int) -> str:
    """The canonical hierarchical-model name for an n-deep topology."""
    return _HIER_WORDS.get(n_levels, f"{n_levels}-level")


def check_hierarchy(hierarchy: str, n_levels: int | None = None) -> None:
    """Validate a hierarchy string: "flat" always parses; the hierarchical
    spelling must match the level count when one is given."""
    if hierarchy == "flat":
        return
    if n_levels is not None:
        if hierarchy != hier_name(n_levels):
            raise ValueError(
                f"hierarchy must be 'flat' or {hier_name(n_levels)!r} for a "
                f"{n_levels}-level topology, got {hierarchy!r}")
        return
    stem = hierarchy[: -len("-level")] if hierarchy.endswith("-level") else ""
    known = {w[: -len("-level")] for w in _HIER_WORDS.values()}
    if stem in known or stem.isdigit():
        return
    raise ValueError(f"hierarchy must be 'flat' or a hier_name() spelling "
                     f"('two-level', 'three-level', ..., '<n>-level'), "
                     f"got {hierarchy!r}")


@dataclasses.dataclass(frozen=True)
class Level:
    """One level of the interconnect hierarchy: the mesh axis name(s) it
    shards over (a str, or a tuple of names treated as one flattened ring),
    its fan-out, its per-hop price and its wire bandwidth (kept so that a
    level compares equal to the reference's; the port prices nothing)."""
    axis: "str | tuple[str, ...]"
    size: int
    hop_lat: float
    wire_bw: "float | None" = None

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"level {self.axis!r} needs size >= 1, "
                             f"got {self.size}")
        if self.hop_lat < 0:
            raise ValueError(f"level {self.axis!r} needs hop_lat >= 0, "
                             f"got {self.hop_lat}")
        if self.wire_bw is not None and self.wire_bw <= 0:
            raise ValueError(f"level {self.axis!r} needs wire_bw > 0, "
                             f"got {self.wire_bw}")

    @property
    def axes(self) -> tuple:
        """``axis`` normalised to a tuple of mesh-axis names."""
        return (self.axis,) if isinstance(self.axis, str) else tuple(self.axis)


def _as_level(entry) -> Level:
    return entry if isinstance(entry, Level) else Level(*entry)


@dataclasses.dataclass(frozen=True, init=False)
class Topology:
    """An N-deep machine geometry: ``levels`` outermost first, and the
    pricing model's name (``hierarchy``).  Equality is by value.  The
    two-entry form ``Topology(C, L, hierarchy=..., cluster_axis=...,
    lane_axis=..., intra_hop_lat=..., inter_hop_lat=...)`` builds the
    two-level geometry; ``levels=`` (or :meth:`from_levels`) any depth."""

    levels: tuple
    hierarchy: str

    def __init__(self, n_clusters: int | None = None,
                 lanes_per_cluster: int | None = None,
                 hierarchy: str | None = None,
                 cluster_axis: "str | tuple[str, ...]" = "cluster",
                 lane_axis: "str | tuple[str, ...]" = "lane",
                 intra_hop_lat: float = 2.0,
                 inter_hop_lat: float = 4.0,
                 *, levels=None):
        if levels is not None:
            if n_clusters is not None or lanes_per_cluster is not None:
                raise ValueError("pass either levels= or "
                                 "(n_clusters, lanes_per_cluster), not both")
            levels = tuple(_as_level(l) for l in levels)
            if not levels:
                raise ValueError("need at least one level")
        else:
            if n_clusters is None or lanes_per_cluster is None:
                raise ValueError("pass (n_clusters, lanes_per_cluster) or "
                                 "levels=")
            if n_clusters < 1 or lanes_per_cluster < 1:
                raise ValueError(
                    f"need >=1 cluster and >=1 lane/cluster, got "
                    f"C={n_clusters} L={lanes_per_cluster}")
            levels = (Level(cluster_axis, n_clusters, inter_hop_lat),
                      Level(lane_axis, lanes_per_cluster, intra_hop_lat))
        if hierarchy is None:
            hierarchy = hier_name(len(levels))
        check_hierarchy(hierarchy, len(levels))
        names = [l.axis for l in levels]
        if len(set(names)) != len(names):
            raise ValueError(f"level axis names must be unique, got {names}")
        object.__setattr__(self, "levels", levels)
        object.__setattr__(self, "hierarchy", hierarchy)

    @classmethod
    def from_levels(cls, levels, hierarchy: str | None = None) -> "Topology":
        """Build from ``[(axis, size, hop_lat), ...]`` (outermost first)."""
        return cls(levels=levels, hierarchy=hierarchy)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def shape(self) -> tuple:
        """Per-level sizes, outermost first (the mesh shape)."""
        return tuple(l.size for l in self.levels)

    @property
    def axis_names(self) -> tuple:
        """Per-level axis entries, outermost first."""
        return tuple(l.axis for l in self.levels)

    def strides(self) -> tuple[int, ...]:
        """Flattened-ring positions spanned by one step of each level
        (outermost first; the innermost stride is always 1)."""
        out, s = [], 1
        for l in reversed(self.levels):
            out.append(s)
            s *= l.size
        return tuple(reversed(out))

    def coords(self, p: int) -> tuple:
        """Flattened ring position p (outer-major) -> per-level coordinates,
        outermost first."""
        p %= math.prod(self.shape)
        return tuple((p // stride) % l.size
                     for stride, l in zip(self.strides(), self.levels))


def mesh_levels(topology: Topology, mesh_shape) -> list:
    """Resolve a topology's levels against a mesh: (mesh-axes tuple, size)
    pairs, outermost first, checking that every level axis exists in
    ``mesh_shape`` (a mapping of axis name -> size) and that the sizes
    agree (the reference's messages)."""
    levels = []
    for l in topology.levels:
        axes = l.axes
        size = 1
        for a in axes:
            if a not in mesh_shape:
                raise ValueError(f"topology level axis {a!r} not in mesh "
                                 f"axes {tuple(mesh_shape)}")
            size *= mesh_shape[a]
        if size != l.size:
            raise ValueError(f"topology level {l.axis!r} size {l.size} != "
                             f"mesh size {size}")
        levels.append((axes, size))
    return levels


def parse_topology(s: str, *, level_axes=None, hop_lats=None, **kw) -> Topology:
    """Parse ``S1xS2x...xSk[:hierarchy]`` (sizes outermost first) into a
    :class:`Topology`.  Two sizes take the two-level constructor's keywords
    (``cluster_axis``, ``lane_axis``, ``intra_hop_lat``,
    ``inter_hop_lat``); deeper specs name their levels from ``level_axes``
    (default ``("pod", "cluster", "lane")`` innermost last, outer levels
    "l4", "l5", ...) and price them from ``hop_lats`` (2, 4, 8, ...
    doubling outward).  Keywords that do not apply to the spec's depth
    raise."""
    spec, _, hierarchy = s.partition(":")
    try:
        sizes = tuple(int(part) for part in spec.split("x"))
        if len(sizes) < 2:
            raise ValueError(spec)
    except ValueError:
        raise ValueError(f"topology spec must look like '16x4[:hierarchy]' "
                         f"or '2x8x4[:hierarchy]', got {s!r}") from None
    if len(sizes) == 2:
        if level_axes is not None or hop_lats is not None:
            raise ValueError(
                f"level_axes/hop_lats apply to specs deeper than two levels; "
                f"for {s!r} use cluster_axis/lane_axis and "
                f"intra_hop_lat/inter_hop_lat")
        if hierarchy:
            kw["hierarchy"] = hierarchy
        return Topology(*sizes, **kw)
    if kw:
        raise ValueError(
            f"{sorted(kw)} apply to two-level specs only; for {s!r} pass "
            f"level_axes=/hop_lats= (one entry per level)")
    k = len(sizes)
    if level_axes is None:
        pad = tuple(f"l{j}" for j in range(k, len(DEFAULT_LEVEL_AXES), -1))
        level_axes = (pad + DEFAULT_LEVEL_AXES)[-k:]
    if len(level_axes) != k:
        raise ValueError(f"need {k} level axes for {s!r}, got {level_axes}")
    if hop_lats is None:
        hop_lats = tuple(default_hop_lat(k - 1 - i) for i in range(k))
    if len(hop_lats) != k:
        raise ValueError(f"need {k} hop latencies for {s!r}, got {hop_lats}")
    levels = [Level(a, n, lat) for a, n, lat in zip(level_axes, sizes, hop_lats)]
    return Topology(levels=levels, hierarchy=hierarchy or None)
