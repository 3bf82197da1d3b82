"""The port's ``Topology`` prices the machine as the JAX package's does:
every pricing method equal, exactly, on every power-of-two (C, L) of 8, 16
and 64 lanes under both hierarchies and on the three-level (2, 2, 2)
machine; ``describe()`` records equal both ways, and ``from_describe``
round-trips (the carry-over of a recorded topology)."""
import pytest

from repro import topology as jt
from repro_torch import topology as pt
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


def _pairs():
    out = []
    for n in (8, 16, 64):
        for C, L in pt.factorizations(n):
            for h in pt.HIERARCHIES:
                out.append((f"{C}x{L}:{h}", pt.Topology(C, L, hierarchy=h),
                            jt.Topology(C, L, hierarchy=h)))
    lv = [("pod", 2, 8.0), ("cluster", 2, 4.0), ("lane", 2, 2.0)]
    for h in ("flat", "three-level"):
        out.append((f"2x2x2:{h}", pt.Topology.from_levels(lv, h),
                    jt.Topology.from_levels(lv, h)))
    # a priced deeper machine with explicit wire bandwidths
    lv = [("pod", 2, 9.0, 10e9), ("cluster", 4, 3.0), ("lane", 4, 1.5, 70e9)]
    out.append(("2x4x4:priced", pt.Topology.from_levels(lv),
                jt.Topology.from_levels(lv)))
    return out


PAIRS = _pairs()
IDS = [p[0] for p in PAIRS]


def test_factorizations_equal_the_reference():
    for n in (1, 2, 6, 8, 12, 16, 64):
        for p2 in (True, False):
            assert pt.factorizations(n, p2) == jt.factorizations(n, p2)
    assert [pt.default_wire_bw(d) for d in range(5)] == \
        [jt.default_wire_bw(d) for d in range(5)]
    assert (pt.HIERARCHIES, pt.LEVELS, pt.DEFAULT_WIRE_BW) == \
        (jt.HIERARCHIES, jt.LEVELS, jt.DEFAULT_WIRE_BW)


@pytest.mark.parametrize("tag,p,j", PAIRS, ids=IDS)
def test_geometry_and_wire_classes_equal_the_reference(tag, p, j):
    for name in ("n_levels", "shape", "n_lanes", "n_clusters",
                 "lanes_per_cluster", "grid", "cluster_axis", "lane_axis",
                 "intra_hop_lat", "inter_hop_lat", "axis_names"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.strides() == j.strides() and p.wire_labels() == j.wire_labels()
    n = p.n_lanes
    for q in range(-1, n + 2):
        assert p.coords(q) == j.coords(q)
        assert (p.cluster_of(q), p.lane_of(q), p.link_level(q)) == \
            (j.cluster_of(q), j.lane_of(q), j.link_level(q)), q
    for label in p.wire_labels():
        assert p.hop_lat(label) == j.hop_lat(label)
        assert p.wire_bw(label) == j.wire_bw(label)
    with pytest.raises(ValueError):
        p.hop_lat("nowhere")


@pytest.mark.parametrize("tag,p,j", PAIRS, ids=IDS)
def test_hop_and_slide_prices_equal_the_reference(tag, p, j):
    n = p.n_lanes
    for src in range(n):
        for dst in range(n):
            assert p.hop_cost(src, dst) == j.hop_cost(src, dst), (src, dst)
    for hops in range(-1, 2 * n + 3):
        assert p.slide_steps(hops) == j.slide_steps(hops), hops
        assert p.slide_crossings(hops) == j.slide_crossings(hops), hops
        assert p.slide_level(hops) == j.slide_level(hops), hops
        assert p.slide_cost(hops) == j.slide_cost(hops), hops
    assert p.tree_wire_cycles() == j.tree_wire_cycles()
    for size in (1, 2, 3, 8, 64):
        assert list(pt.Topology.tree_stages(size)) == \
            list(jt.Topology.tree_stages(size))


@pytest.mark.parametrize("tag,p,j", PAIRS, ids=IDS)
def test_derived_topologies_equal_the_reference(tag, p, j):
    d = p.describe()
    assert d == j.describe()
    # a record rebuilds the same priced machine in either package (its
    # levels carry the resolved wire bandwidths, as the reference's do)
    back = pt.Topology.from_describe(j.describe())
    assert back.describe() == d
    assert back.levels == tuple(pt.Level(*vars(l).values())
                                for l in jt.Topology.from_describe(d).levels)
    assert jt.Topology.from_describe(d).describe() == d
    for h in ("flat", jt.hier_name(p.n_levels)):
        assert p.with_hierarchy(h).describe() == j.with_hierarchy(h).describe()
    assert p.with_grid(4, 2).describe() == j.with_grid(4, 2).describe()
    lv = [("pod", 2, 8.0), ("cluster", 4, 4.0), ("lane", 2, 2.0)]
    assert p.with_levels(lv).describe() == j.with_levels(lv).describe()
    assert p.with_levels(lv, "flat").describe() == \
        j.with_levels(lv, "flat").describe()
