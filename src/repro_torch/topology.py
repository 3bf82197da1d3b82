"""Topology: the machine geometry as levels of rings (pods of clusters of
lanes), outermost first, and its pricing.

The port's copy of ``repro.topology`` (pure Python, no torch), whole:
``Level``; ``Topology`` with its constructors, its geometry (``n_levels``,
``shape``, ``n_lanes``, ``n_clusters``, ``grid``, ``strides``, ``coords``,
...), the per-level wire pricing that the cycle model reads (``hop_cost``,
``slide_steps``, ``slide_cost``, ``tree_wire_cycles``, ``wire_bw``, ...)
and ``describe``/``from_describe``; ``check_hierarchy``, ``mesh_levels``,
``factorizations`` and ``parse_topology``.

Every level prices its own wires: ``levels[i].hop_lat`` is the cycles of
one hop on level i's interconnect, and a link of the flattened
(outer-major) ring is priced by the outermost boundary it crosses.  Wire
classes are labelled ``"intra"`` (the innermost level), ``"inter"`` (the
level above it) and by the level's own name further out.
``hierarchy="flat"`` prices every hop at the outermost class (the
flattened ring the paper argues against); the hierarchical model
(``"two-level"``, ``"three-level"``, ...) prices each link and stage by
the level it rides.

The distributed layers read a topology's levels as the named dimensions of
a process mesh (the hierarchical MoE all-to-all, ring attention's KV
rotation, the vector machine's rings in ``repro_torch.core``), and
``repro_torch.sim.AraXLParams.topology`` is the same type, so the machine
and the cycle model share one geometry value.  A reference topology's
``describe()`` gives an equal port ``Topology`` through
:meth:`Topology.from_describe`.
"""
from __future__ import annotations

import dataclasses
import math

#: the two historical interconnect models (kept for the two-level case;
#: deeper topologies name their hierarchical model "<n>-level")
HIERARCHIES = ("flat", "two-level")

#: the two historical wire classes; deeper levels label wires by level name
LEVELS = ("intra", "inter")

#: "<n>-level" spellings for the common depths (hier_name falls back to
#: the numeric form for anything deeper)
_HIER_WORDS = {1: "one-level", 2: "two-level", 3: "three-level",
               4: "four-level", 5: "five-level"}

#: default per-level axis names for parse_topology("PxCxL") style specs,
#: innermost last; levels beyond the pod are named by their depth from the
#: innermost (lane=1, cluster=2, pod=3): "l4", "l5", ...
DEFAULT_LEVEL_AXES = ("pod", "cluster", "lane")

#: default per-hop wire price for level j counted from the innermost
#: (lane) level outward: 2, 4, 8, ... cycles — each level's wires are
#: roughly twice as long as the level below.
def default_hop_lat(depth_from_inner: int) -> float:
    return 2.0 * (2 ** depth_from_inner)


#: default innermost-level wire bandwidth, bytes/s (the reference's flat
#: launch-layer link price, so a single-level topology prices collectives
#: as a flat link does).
DEFAULT_WIRE_BW = 50e9


#: default per-level wire bandwidth counted from the innermost level
#: outward: 50, 25, 12.5 ... GB/s — each level's longer wires carry half
#: the bandwidth of the level below (the launch-layer dual of
#: :func:`default_hop_lat`: latency doubles outward, bandwidth halves).
def default_wire_bw(depth_from_inner: int) -> float:
    return DEFAULT_WIRE_BW / (2 ** depth_from_inner)


def hier_name(n_levels: int) -> str:
    """The canonical hierarchical-model name for an n-deep topology."""
    return _HIER_WORDS.get(n_levels, f"{n_levels}-level")


def check_hierarchy(hierarchy: str, n_levels: int | None = None) -> None:
    """Validate a hierarchy string: "flat" always parses; the hierarchical
    spelling must match the level count when one is given (so a two-entry
    topology still rejects "three-level", as it always did)."""
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
    """One level of the interconnect hierarchy.

    ``axis``     mesh-axis name(s) this level shards over (str, or a tuple
                 of names treated as one flattened ring)
    ``size``     fan-out: how many level-(i+1) groups one group contains
    ``hop_lat``  cycles for one hop on this level's wires (the sim price)
    ``wire_bw``  bytes/s one link of this level's wires sustains (the
                 launch-layer price; ``None`` defaults by depth — 50 GB/s
                 innermost, halving outward, see :func:`default_wire_bw`)
    """
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
    if isinstance(entry, Level):
        return entry
    return Level(*entry)


@dataclasses.dataclass(frozen=True, init=False)
class Topology:
    """An N-deep machine geometry: ``levels`` outermost-first, plus which
    pricing model (``hierarchy``) applies.  Equality is by value, so two
    stacks provably share a topology when their ``Topology`` objects
    compare equal.

    The historical two-entry form ``Topology(C, L, hierarchy=...,
    cluster_axis=..., lane_axis=..., intra_hop_lat=..., inter_hop_lat=...)``
    builds the equivalent two-level geometry (the calibrated prices of the
    cycle model); pass ``levels=`` (or use :meth:`from_levels`) for deeper
    hierarchies.
    """

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
        # Precomputed pricing tables (the sim prices every trace record
        # through this frozen value, link by link — don't rebuild per call).
        strides, s = [], 1
        for l in reversed(levels):
            strides.append(s)
            s *= l.size
        object.__setattr__(self, "_strides", tuple(reversed(strides)))
        groups, g = [], 1
        for l in levels:
            g *= l.size
            groups.append(g)
        object.__setattr__(self, "_groups_t", tuple(groups))
        labels = []
        for i, l in enumerate(levels):
            depth = len(levels) - 1 - i                # 0 = innermost
            if depth == 0:
                labels.append("intra")
            elif depth == 1:
                labels.append("inter")
            else:
                labels.append(l.axis if isinstance(l.axis, str)
                              else "+".join(l.axis))
        object.__setattr__(self, "_labels", tuple(labels))

    @classmethod
    def from_levels(cls, levels, hierarchy: str | None = None) -> "Topology":
        """Build from ``[(axis, size, hop_lat), ...]`` (outermost first)."""
        return cls(levels=levels, hierarchy=hierarchy)

    # -- geometry -----------------------------------------------------------
    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def shape(self) -> tuple:
        """Per-level sizes, outermost first (the mesh shape)."""
        return tuple(l.size for l in self.levels)

    @property
    def n_lanes(self) -> int:
        """Total lanes (= flattened ring size = product of all fan-outs)."""
        return math.prod(self.shape)

    @property
    def n_clusters(self) -> int:
        """Groups seen by the innermost level: the product of every outer
        fan-out (multi-pod machines fold their pods in here)."""
        return self.n_lanes // self.lanes_per_cluster

    @property
    def lanes_per_cluster(self) -> int:
        return self.levels[-1].size

    @property
    def grid(self) -> tuple[int, int]:
        return (self.n_clusters, self.lanes_per_cluster)

    @property
    def cluster_axis(self) -> "str | tuple[str, ...]":
        """Axis name(s) of everything above the lane level (a single name
        for two-level topologies, a tuple for deeper ones)."""
        outer = self.levels[:-1]
        if len(outer) == 1:
            return outer[0].axis
        names: list = []
        for l in outer:
            names.extend((l.axis,) if isinstance(l.axis, str) else l.axis)
        return tuple(names)

    @property
    def lane_axis(self) -> "str | tuple[str, ...]":
        return self.levels[-1].axis

    @property
    def intra_hop_lat(self) -> float:
        """Hop price of the innermost (intra-cluster) wires."""
        return self.levels[-1].hop_lat

    @property
    def inter_hop_lat(self) -> float:
        """Hop price of the level just above the lanes (the RINGI ring)."""
        return self.levels[-2].hop_lat if self.n_levels > 1 \
            else self.levels[-1].hop_lat

    @property
    def axis_names(self) -> tuple:
        """Per-level axis entries, outermost first."""
        return tuple(l.axis for l in self.levels)

    def strides(self) -> tuple[int, ...]:
        """Flattened-ring positions spanned by one step of each level
        (outermost first; the innermost stride is always 1)."""
        return self._strides

    def coords(self, p: int) -> tuple:
        """Flattened ring position p (outer-major) -> per-level coordinates
        (outermost first; ``(c, l)`` for a two-level topology)."""
        p %= self.n_lanes
        out = []
        for stride, l in zip(self.strides(), self.levels):
            out.append((p // stride) % l.size)
        return tuple(out)

    def cluster_of(self, p: int) -> int:
        """Flattened index of the cluster holding ring position p."""
        return (p % self.n_lanes) // self.lanes_per_cluster

    def lane_of(self, p: int) -> int:
        return p % self.lanes_per_cluster

    # -- wire pricing -------------------------------------------------------
    def wire_labels(self) -> tuple[str, ...]:
        """Per-level wire-class labels, outermost first.  The innermost two
        keep their historical names ("intra" / "inter"); deeper levels are
        labelled by their axis name (e.g. "pod")."""
        return self._labels

    def _groups(self) -> tuple[int, ...]:
        """Cumulative group counts, outermost first: how many level-i blocks
        the whole machine contains (1 means level i has no boundaries)."""
        return self._groups_t

    def _link_index(self, p: int) -> int:
        """Level index (outermost first) whose wires the ring link p -> p+1
        rides: the outermost level whose coordinate changes across the link
        (including the wrap link n-1 -> 0)."""
        v = (p % self.n_lanes) + 1
        groups = self._groups()
        for i, stride in enumerate(self.strides()):
            if groups[i] > 1 and v % stride == 0:
                return i
        return self.n_levels - 1

    def link_level(self, p: int) -> str:
        """Wire class of the ring link p -> p+1: the *outermost* boundary it
        crosses (including the wrap link n-1 -> 0)."""
        return self.wire_labels()[self._link_index(p)]

    def hop_lat(self, level: str) -> float:
        """Hop price of one wire class (by label, see :meth:`wire_labels`)."""
        labels = self.wire_labels()
        if level not in labels:
            raise ValueError(f"level must be one of {labels}, got {level!r}")
        return self.levels[labels.index(level)].hop_lat

    def wire_bw(self, level: str) -> float:
        """Wire bandwidth (bytes/s) of one wire class, by label.  Always a
        float: levels built without an explicit ``wire_bw`` resolve to the
        depth default (:func:`default_wire_bw` — 50 GB/s innermost, halving
        outward), so equality-by-value between default-priced topologies is
        unaffected by the launch-layer prices."""
        labels = self.wire_labels()
        if level not in labels:
            raise ValueError(f"level must be one of {labels}, got {level!r}")
        i = labels.index(level)
        l = self.levels[i]
        if l.wire_bw is not None:
            return l.wire_bw
        return default_wire_bw(self.n_levels - 1 - i)

    def hop_cost(self, src: int, dst: int) -> float:
        """Cycles for one transfer from ring position ``src`` forward to
        ``dst`` (sum of link prices along the directed ring path).  Under
        the flat hierarchy every link is priced as the outermost (longest)
        wire class."""
        n = self.n_lanes
        steps = (dst - src) % n
        if self.hierarchy == "flat":
            return steps * self.levels[0].hop_lat
        return sum(self.levels[self._link_index((src + i) % n)].hop_lat
                   for i in range(steps))

    def slide_steps(self, hops: int) -> tuple[int, ...]:
        """Critical-path step counts per level (outermost first) of a slide
        by ``hops`` positions: the slowest lane crosses
        ``ceil(hops / span_i)`` boundaries of level i or outer (span_i =
        positions per level-i block), and each crossing is priced at the
        outermost level it touches."""
        hops = max(0, hops)
        groups = self._groups()
        steps, prev = [], 0
        for i, stride in enumerate(self.strides()):
            if groups[i] > 1:
                # level-i-or-outer boundaries recur every stride_i ring
                # positions, so a window of `hops` consecutive links holds
                # at most ceil(hops / stride_i) of them
                b = min(hops, math.ceil(hops / stride))
            else:
                b = prev
            steps.append(b - prev)
            prev = b
        # innermost level absorbs every remaining step (degenerate 1-lane
        # machines included)
        steps[-1] += hops - prev
        return tuple(steps)

    def slide_crossings(self, hops: int) -> int:
        """Boundary crossings above the innermost level on the critical
        lane path of a slide by ``hops`` (the completion bound)."""
        return sum(self.slide_steps(hops)[:-1])

    def slide_level(self, hops: int = 1) -> str:
        """Wire class the critical path of a ``hops``-position slide crosses
        (the outermost level any lane must touch)."""
        steps = self.slide_steps(max(1, hops))
        for label, s in zip(self.wire_labels(), steps):
            if s:
                return label
        return self.wire_labels()[-1]

    def slide_cost(self, hops: int) -> float:
        """Critical-path cycles before a slide by ``hops`` can stream.

        flat:          every hop is priced at the outermost wire class.
        hierarchical:  the slowest lane crosses ceil(hops/stride_i)
                       boundaries of each level; each crossing is priced at
                       the outermost level it touches, the remaining steps
                       ride the short innermost wires.
        """
        hops = max(0, hops)
        if self.hierarchy == "flat":
            return hops * self.levels[0].hop_lat
        return sum(s * l.hop_lat
                   for s, l in zip(self.slide_steps(hops), self.levels))

    @staticmethod
    def tree_stages(size: int):
        """Recursive-doubling stage distances 1, 2, 4, ... < size (the
        §III-B.4 log-tree: stage s rides s ring hops)."""
        s = 1
        while s < size:
            yield s
            s *= 2

    def tree_wire_cycles(self) -> float:
        """Pure wire cycles of a full cross-machine log-tree reduction.

        flat:          every stage spans the whole flattened ring at the
                       outermost wire price.
        hierarchical:  log2(size_i) stages per level, each on that level's
                       own wires — the long wires never see inner-level
                       traffic, which is the paper's physical-scalability
                       claim (and it recurses: pod wires never see cluster
                       traffic either).

        Note this prices bare wires only; AraXL's *reduction* pipeline runs
        its intra-cluster stages through the calibrated A2A stage
        (``AraXLParams.interlane_lat``), so ``red_tree_lat`` consumes this
        method's outer-level terms but substitutes its own intra-cluster
        stage cost.
        """
        if self.hierarchy == "flat":
            return sum(s * self.levels[0].hop_lat
                       for s in self.tree_stages(self.n_lanes))
        return sum(s * l.hop_lat
                   for l in self.levels for s in self.tree_stages(l.size))

    # -- derivation helpers -------------------------------------------------
    def with_hierarchy(self, hierarchy: str) -> "Topology":
        return Topology(levels=self.levels, hierarchy=hierarchy)

    def with_levels(self, levels, hierarchy: str | None = None) -> "Topology":
        """Same pricing model, new geometry (hierarchy respelled to the new
        depth unless explicitly given or flat)."""
        if hierarchy is None and self.hierarchy == "flat":
            hierarchy = "flat"
        return Topology(levels=levels, hierarchy=hierarchy)

    def with_grid(self, n_clusters: int, lanes_per_cluster: int) -> "Topology":
        """Re-factorise as a two-level C x L machine.  Both the axis name
        and the wire price of the new outer level come from the ring level
        just above the lanes (``inter_hop_lat``); on a deeper topology the
        levels outside that ring are folded away (their counts live on in
        ``n_clusters``)."""
        ring = self.levels[-2] if self.n_levels > 1 else self.levels[0]
        inner = self.levels[-1]
        lvls = (Level(ring.axis, n_clusters, self.inter_hop_lat,
                      ring.wire_bw),
                Level(inner.axis if self.n_levels > 1 else "lane",
                      lanes_per_cluster, self.intra_hop_lat, inner.wire_bw))
        hierarchy = "flat" if self.hierarchy == "flat" else None
        return Topology(levels=lvls, hierarchy=hierarchy)

    @classmethod
    def from_describe(cls, d: dict) -> "Topology":
        """Rebuild a Topology from a :meth:`describe` record (the JSON the
        dry-run / perf artifacts store), levels, prices, and hierarchy
        intact — so recorded artifacts can be re-priced offline."""
        levels = [Level(tuple(l["axis"]) if isinstance(l["axis"], list)
                        else l["axis"], l["size"], l["hop_lat"],
                        l.get("wire_bw"))
                  for l in d["levels"]]
        return cls(levels=levels, hierarchy=d["hierarchy"])

    def describe(self) -> dict:
        """JSON-friendly record (benchmarks / dry-run artifacts)."""
        return {
            "n_levels": self.n_levels,
            "levels": [{"axis": list(l.axis) if isinstance(l.axis, tuple)
                        else l.axis,
                        "size": l.size, "hop_lat": l.hop_lat,
                        "wire_bw": self.wire_bw(lab)}
                       for l, lab in zip(self.levels, self.wire_labels())],
            "n_clusters": self.n_clusters,
            "lanes_per_cluster": self.lanes_per_cluster,
            "n_lanes": self.n_lanes,
            "hierarchy": self.hierarchy,
            "cluster_axis": self.cluster_axis,
            "lane_axis": self.lane_axis,
            "intra_hop_lat": self.intra_hop_lat,
            "inter_hop_lat": self.inter_hop_lat,
        }


def mesh_levels(topology: Topology, mesh_shape) -> list:
    """Resolve a topology's levels against a mesh: (mesh-axes tuple, size)
    pairs, outermost first, validating that every level axis exists in
    ``mesh_shape`` (a mapping of axis name -> size) and that the sizes
    agree.  Shared by the hierarchical workloads (ring attention, MoE
    all-to-all) so level/mesh mismatch errors are raised once, identically.
    """
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


def factorizations(n_lanes: int, power_of_two: bool = True):
    """All (C, L) grids with C*L == n_lanes — the fig6 factorisation sweep
    (64 lanes as 16x4 / 8x8 / 4x16 / ...)."""
    out = []
    for L in range(1, n_lanes + 1):
        if n_lanes % L:
            continue
        C = n_lanes // L
        if power_of_two and ((C & (C - 1)) or (L & (L - 1))):
            continue
        out.append((C, L))
    return out


def parse_topology(s: str, *, level_axes=None, hop_lats=None, **kw) -> Topology:
    """Parse an N-level topology spec into a :class:`Topology`.

    Grammar: ``S1xS2x...xSk[:hierarchy]`` — sizes outermost first, e.g.
    ``"16x4"`` (two-level), ``"16x4:flat"``, ``"2x8x4"`` (pods x clusters
    x lanes), ``"2x8x4:flat"``.

    Two sizes keep the legacy keywords (``cluster_axis`` / ``lane_axis`` /
    ``intra_hop_lat`` / ``inter_hop_lat`` pass through to the two-level
    constructor).  Deeper specs name their levels
    from ``level_axes`` (default: ``("pod", "cluster", "lane")`` innermost-
    last; levels outside the pod are named by depth from the innermost —
    "l4", "l5", ...) and price them from ``hop_lats`` (default: 2, 4, 8,
    ... cycles doubling outward).  Keywords that don't apply to the spec's
    depth raise.
    """
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
    levels = [Level(a, n, lat) for a, n, lat in zip(level_axes, sizes,
                                                    hop_lats)]
    return Topology(levels=levels, hierarchy=hierarchy or None)
