"""The port's roofline (``repro_torch.roofline.analysis``) against the
reference's (``repro.roofline.analysis``) on the same inputs: every copied
function, with ``hw=`` the reference's constants, gives the reference's
numbers.  The collectives are the reference's ``parse_collectives`` output of
the HLO snippets its own tests use (``tests/test_roofline_levels.py``),
converted to the records ``parallel.comm`` writes, and the recorded smoke
fixture; then the records comm writes on a fake process group."""
import json
import math
import pathlib

import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import SHAPES as JAX_SHAPES
from repro.roofline import analysis as ja
from repro.topology import Topology as JTopology
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.specs import SHAPES
from repro_torch.parallel import comm
from repro_torch.roofline import analysis as ta
from repro_torch.topology import Level, Topology
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

DATA = pathlib.Path(__file__).parent / "data"
JHW = dict(ja.HW)

#: the HLO snippets of tests/test_roofline_levels.py
SNIPPETS = [
    "  ag = bf16[512]{0} all-gather(bf16[32]{0} p), replica_groups=[32,16]<=[512], dimensions={0}",
    "  ar = f32[128]{0} all-reduce(f32[128]{0} q), replica_groups=[16,32]<=[32,16]T(1,0)",
    """
  rs = f32[64]{0} reduce-scatter(f32[256]{0} s), replica_groups={{0,1,2,3},{4,5,6,7}}
  cp = f32[64]{0} collective-permute(f32[64]{0} r), source_target_pairs={{0,1},{1,2},{2,3},{3,0}}
""",
    """
  ags = bf16[512]{0} all-gather-start(bf16[32]{0} p), replica_groups=[32,16]<=[512], dimensions={0}
  agd = bf16[512]{0} all-gather-done(bf16[512]{0} ags)
""",
    "  cp = f32[64]{0} collective-permute(f32[64]{0} r), source_target_pairs={{600,601},{0,1}}",
    """
  ag = bf16[512]{0} all-gather(bf16[32]{0} p), replica_groups=[32,16]<=[512], dimensions={0}
  ar = f32[128]{0} all-reduce(f32[128]{0} q), replica_groups=[16,32]<=[32,16]T(1,0)
  rs = f32[64]{0} reduce-scatter(f32[256]{0} s), replica_groups={{0,1,2,3}}
""",
    "  cp = f32[64]{0} collective-permute(f32[64]{0} r), source_target_pairs={{0,16},{16,32},{256,0},{0,1}}",
    "  ar = f32[4096]{0} all-reduce(f32[4096]{0} q), replica_groups=[1,512]<=[512]",
]

LEVELS3 = [("pod", 2, 8.0), ("data", 16, 4.0), ("model", 16, 2.0)]


def _topos(levels, hierarchy=None):
    return (JTopology.from_levels(levels, hierarchy=hierarchy),
            Topology.from_levels(levels, hierarchy=hierarchy))


def _records(colls) -> list:
    """The reference's parsed collectives as the port's records."""
    return [{k: v for k, v in c.items() if k != "line"} for c in colls]


TOPOS = {
    "3-level": LEVELS3,
    "2-level": [("data", 32, 4.0), ("model", 16, 2.0)],
    "1-level": [("model", 512, 2.0)],
}


@pytest.mark.parametrize("hier", [None, "flat"])
@pytest.mark.parametrize("topo", sorted(TOPOS))
@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_collective_pricing_equals_the_reference(i, topo, hier):
    colls = ja.parse_collectives(SNIPPETS[i])
    jt, tt = _topos(TOPOS[topo], hier)
    recs = _records(colls)
    assert ta.collective_bytes(recs) == ja.collective_bytes(colls)
    jl, tl = ja.collective_level_bytes(colls, jt), ta.collective_level_bytes(recs, tt)
    assert tl == jl
    assert ta.level_wire_seconds(tl, tt) == ja.level_wire_seconds(jl, jt)
    for compute in (0.0, 1e-6, 1e-3):
        secs = ja.level_wire_seconds(jl, jt)
        assert ta.exposed_level_seconds(secs, compute, tt) == \
            ja.exposed_level_seconds(secs, compute, jt)
    total = ja.collective_bytes(colls)["total"]
    assert ta.wire_seconds(total, JHW) == ja.wire_seconds(total)


@pytest.mark.parametrize("members", [
    tuple(range(16)), tuple(range(0, 256, 16)), (0, 256), tuple(range(0, 512, 16)),
    tuple(range(512)), (0, 0), (0, 16, 32), (0, 16, 17), (600, 601), (),
    (3, 19, 259, 275)])
def test_group_level_extents_equal_the_reference(members):
    jt, tt = _topos(LEVELS3)
    assert ta.group_level_extents(members, tt) == ja.group_level_extents(members, jt)


def test_single_level_topology_prices_bit_identically_to_flat():
    """With the reference's link rate, one level prices exactly as
    ``wire_seconds``."""
    tt = Topology.from_levels([("model", 512, 2.0)])
    assert tt.wire_bw("intra") == JHW["ici_bw"]
    recs = _records(ja.parse_collectives(SNIPPETS[-1]))
    lv = ta.collective_level_bytes(recs, tt)
    assert lv["total"] == ta.collective_bytes(recs)["total"]
    assert ta.level_wire_seconds(lv, tt)["total"] == \
        ta.wire_seconds(ta.collective_bytes(recs)["total"], JHW)


def test_recorded_fixture_prices_as_recorded():
    fix = json.loads((DATA / "roofline_collectives_2x2x2.json").read_text())
    d = fix["topology"]
    tt = Topology.from_levels([Level(l["axis"], l["size"], l["hop_lat"], l["wire_bw"])
                               for l in d["levels"]], hierarchy=d["hierarchy"])
    recs = []
    for c in fix["colls"]:
        c = dict(c)
        if "members" in c:
            c["members"] = tuple(c["members"])
        if "pairs" in c:
            c["pairs"] = tuple((s, t) for s, t in c["pairs"])
        recs.append(c)
    flat = ta.collective_bytes(recs)
    assert flat["total"] == fix["flat_bytes_total"]
    assert ta.wire_seconds(flat["total"], JHW) == fix["flat_s"]
    lv = ta.collective_level_bytes(recs, tt)
    assert {k: lv[k] for k in fix["level_bytes"]} == fix["level_bytes"]
    secs = ta.level_wire_seconds(lv, tt)
    assert {k: secs[k] for k in fix["level_s"]} == fix["level_s"]


@pytest.mark.parametrize("args", [(1e15, 1e12, 1e9, None), (1e12, 1e13, 0.0, None),
                                  (1e9, 1e9, 1e12, 0.5), (0.0, 0.0, 0.0, None)])
def test_roofline_terms_equal_the_reference(args):
    assert ta.roofline_terms(*args, hw=JHW) == ja.roofline_terms(*args)


def test_extrapolate_and_mesh_factors_equal_the_reference():
    for f1, f2, n in ((1.0, 3.0, 32), (5e12, 7.5e12, 1), (2.0, 2.0, 4)):
        assert ta.extrapolate(f1, f2, n) == ja.extrapolate(f1, f2, n)
    for levels in TOPOS.values():
        jt, tt = _topos(levels)
        for n in (1, 16, 256, 512):
            assert ta.mesh_factors(n, tt) == ja.mesh_factors(n, jt)
            assert ta.mesh_factors(n) == ja.mesh_factors(n)


@pytest.mark.parametrize("arch", ["llama3-8b", "mixtral-8x7b", "mamba2-370m",
                                  "jamba-1.5-large-398b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_memory_models_equal_the_reference(arch, shape):
    jcfg, cfg = jax_config(arch), get_config(arch)
    jshape, tshape = JAX_SHAPES[shape], SHAPES[shape]
    jt, tt = _topos(LEVELS3)
    for n_dev, nm, topo in ((256, 8, None), (512, 4, (jt, tt)), (1, 1, None)):
        jtop, ttop = topo or (None, None)
        assert ta.resident_model_bytes(cfg, tshape, n_dev, nm, 1.5e9, topology=ttop) == \
            ja.resident_model_bytes(jcfg, jshape, n_dev, nm, 1.5e9, topology=jtop)
        assert ta.memory_model_bytes(cfg, tshape, n_dev, nm, topology=ttop) == \
            ja.memory_model_bytes(jcfg, jshape, n_dev, nm, topology=jtop)


def test_h100_constants_name_the_card():
    assert ta.HW["peak_flops"] == 989e12 and ta.HW["hbm_bw"] == 3.35e12
    assert "H100" in ta.HW["card"]


def test_comm_records_price_by_level():
    """The records comm writes on a fake (2, 4) mesh: an all-reduce over the
    lanes stays on the inner wires, one over the clusters on the outer, a
    shift's pairs cover the whole mesh; priced per level, bytes conserved."""
    with dr.fake_world(8):
        mesh = dr.fake_mesh((2, 4), ("data", "model"))
        x = torch.zeros(4, 8)
        comm.all_reduce_raw(x, "model", mesh)
        comm.all_reduce_raw(x, "data", mesh)
        comm.all_gather_raw(x, ("data", "model"), mesh, 0)
        comm.reduce_scatter_raw(x, "model", mesh, 0)
        comm.ppermute_shift(x, "model", 1, mesh)
    ar_m, ar_d, ag, rs, cp = mesh.records
    assert ar_m == {"kind": "all-reduce", "bytes": 128, "group": 4,
                    "members": (0, 1, 2, 3)}
    assert ar_d["members"] == (0, 4) and ag["members"] == tuple(range(8))
    assert ag["bytes"] == 8 * 128 and rs["bytes"] == 32
    assert cp["kind"] == "collective-permute" and len(cp["pairs"]) == 8
    assert (1, 0) in cp["pairs"] and (4, 7) in cp["pairs"]
    tt = Topology(2, 4, hierarchy="two-level", cluster_axis="data", lane_axis="model")
    lv = ta.collective_level_bytes(mesh.records, tt)
    assert lv["inter"] == 128.0 + 1 / 2 * 1024          # the data all-reduce; ag's outer ring
    assert lv["total"] == pytest.approx(ta.collective_bytes(mesh.records)["total"])
    assert math.isclose(lv["intra"], 2 * 3 / 4 * 128 + 3 / 4 / 2 * 1024 + 3 / 4 * 32 + 128)
