"""The port's rule table, topology, meshes and block cutting against the
JAX package (no ranks: an abstract mesh on both sides): ``spec`` of every
leaf of every registered arch's parameter tree equals the reference's
``default_rules(AbstractMesh(...))`` on three meshes and every option;
``topology.mesh_levels`` and ``parse_topology`` equal the reference's;
``shard_tree`` and ``gather_tree`` invert each other and cut what JAX's
``NamedSharding`` cuts; ``moe_mode`` picks the reference's mode; the
backend is a function of the layout; the sublayers whose mesh branches are
not ported refuse a mesh by name; phase 12 of ``chip_smoke.py`` exits
without a card."""
import dataclasses
import inspect
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import topology as jtopo
from repro.configs import get_config as jax_config
from repro.launch import mesh as jmesh
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.parallel.sharding import ShardingRules as JRules
from repro.parallel.sharding import default_rules as jax_rules
from repro_torch import topology
from repro_torch.configs import archs, get_config, get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (ShardingRules, default_rules, gather_tree,
                                           param_placements, shard_tree)
from repro_torch.params import init_params, tree_leaves

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
OPTIONS = [dict(), dict(batch=6), dict(batch=8), dict(kv_heads=8), dict(kv_heads=2),
           dict(cache_seq="model"), dict(act_seq=True), dict(seq_sharded=True),
           dict(fsdp=False)]


def _p(spec) -> tuple:
    """A PartitionSpec as the port's spec: a tuple of mesh-axis tuples."""
    return tuple(() if e is None else ((e,) if isinstance(e, str) else tuple(e))
                 for e in spec)


def _leaves(defs, prefix=""):
    if isinstance(defs, dict):
        for k, v in defs.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, defs


@pytest.mark.parametrize("name", sorted(archs.CONFIGS))
@pytest.mark.parametrize("shape,names", MESHES, ids=["2x4", "1x8", "2x2x2"])
def test_rule_table_equals_the_reference(name, shape, names):
    """Every leaf of the arch's tree (and of its caches) under every option."""
    jm = AbstractMesh(shape, names)
    tm = comm.Mesh.abstract(shape, names)
    tdefs = dict(_leaves(lm.model_defs(get_config(name))))
    jdefs = dict(_leaves(jlm.model_defs(jax_config(name))))
    assert set(tdefs) == set(jdefs)
    cache = dict(_leaves(lm.cache_defs(get_config(name), 8, 64)))
    for opts in OPTIONS:
        jr, tr = jax_rules(jm, **opts), default_rules(tm, **opts)
        assert tr.rules == {k: v for k, v in jr.rules.items()}, opts
        for path, pv in list(tdefs.items()) + list(cache.items()):
            assert tr.spec(pv.logical) == _p(jr.spec(pv.logical)), (path, opts)
    for path, pv in tdefs.items():
        assert pv.logical == jdefs[path].logical, path


def test_rules_map_tuples_and_never_one_axis_twice():
    """A rule naming several mesh axes (the hierarchical MoE's), and a spec
    whose two logical axes map to one mesh axis, as the reference does."""
    shape, names = (2, 2, 2), ("pod", "cluster", "lane")
    rules = {"batch": None, "fsdp": None, "model": names, "kv": None,
             "cache_seq": "lane", "act_seq": names}
    jr = JRules(AbstractMesh(shape, names), rules)
    tr = ShardingRules(comm.Mesh.abstract(shape, names), rules)
    for logical in [("model", "", ""), ("", "model", "act_seq"), ("cache_seq", "model"),
                    ("batch", "act_seq", ""), ("model", "model")]:
        assert tr.spec(logical) == _p(jr.spec(logical)), logical
    assert ShardingRules().spec(("model",)) == ()


@pytest.mark.parametrize("spec", ["16x4", "16x4:flat", "2x8x4", "2x8x4:flat",
                                  "2x2x2", "3x2x2x2", "8x8:two-level"])
def test_parse_topology_and_mesh_levels_equal_the_reference(spec):
    got, want = topology.parse_topology(spec), jtopo.parse_topology(spec)
    assert (got.shape, got.axis_names, got.hierarchy, got.strides()) == \
        (want.shape, want.axis_names, want.hierarchy, want.strides())
    assert [l.hop_lat for l in got.levels] == [l.hop_lat for l in want.levels]
    assert all(got.coords(p) == want.coords(p) for p in range(2 * math.prod(got.shape)))
    shape = dict(zip(got.axis_names, got.shape))
    assert topology.mesh_levels(got, shape) == jtopo.mesh_levels(want, shape)
    lg, lw = tmesh.parse_launch_topology(spec), jmesh.parse_launch_topology(spec)
    assert (lg.shape, lg.axis_names, lg.hierarchy) == (lw.shape, lw.axis_names,
                                                       lw.hierarchy)
    assert tmesh.topology_tag(lg) == jmesh.topology_tag(lw)


def test_topology_refusals_match_the_reference():
    t = topology.Topology.from_levels([("pod", 2, 8.0), ("lane", 4, 2.0)])
    j = jtopo.Topology.from_levels([("pod", 2, 8.0), ("lane", 4, 2.0)])
    for bad in ({"pod": 2}, {"pod": 2, "lane": 2}):
        with pytest.raises(ValueError) as eg:
            topology.mesh_levels(t, bad)
        with pytest.raises(ValueError) as ew:
            jtopo.mesh_levels(j, bad)
        assert str(eg.value) == str(ew.value)
    for spec in ("16", "axb", "2x2:three-level"):
        with pytest.raises(ValueError):
            topology.parse_topology(spec)
        with pytest.raises(ValueError):
            jtopo.parse_topology(spec)
    for multi in (False, True):
        g, w = (tmesh.production_topology(multi_pod=multi),
                jmesh.production_topology(multi_pod=multi))
        assert (g.shape, g.axis_names, g.hierarchy) == (w.shape, w.axis_names,
                                                        w.hierarchy)


@pytest.mark.parametrize("shape,names", MESHES, ids=["2x4", "1x8", "2x2x2"])
@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-moe-235b-a22b"])
def test_shard_tree_cuts_what_jax_cuts_and_gather_tree_inverts_it(name, shape, names):
    """Each rank's block is the slice JAX's ``NamedSharding`` gives the
    device at its mesh coordinates (its ``devices_indices_map``), and the
    ranks' blocks gather back to the whole tree."""
    cfg = dataclasses.replace(get_smoke_config(name), n_experts=8)
    defs = lm.model_defs(cfg)
    tree = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    mesh = comm.Mesh.abstract(shape, names)
    rules = default_rules(mesh, kv_heads=cfg.n_kv_heads)
    blocks = [shard_tree(tree, defs, rules, r) for r in range(mesh.size)]
    back = gather_tree(blocks, defs, rules)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    jm = jax.make_mesh(shape, names)          # conftest's 8 CPU devices
    jrules = jax_rules(jm, kv_heads=cfg.n_kv_heads)
    for (path, pv), whole, *bl in zip(_leaves(defs), tree_leaves(tree),
                                      *(tree_leaves(b) for b in blocks)):
        idx = jax.sharding.NamedSharding(jm, jrules.spec(pv.logical)) \
            .devices_indices_map(pv.shape)
        for r, dev in enumerate(jm.devices.flat):
            assert torch.equal(bl[r], whole[idx[dev]]), (path, r)


def test_moe_mode_equals_the_reference():
    shape, names = (2, 4), ("data", "model")
    jm, tm = AbstractMesh(shape, names), comm.Mesh.abstract(shape, names)
    for name, over in [("qwen3-moe-235b-a22b", {}), ("qwen3-moe-235b-a22b",
                                                     {"moe_impl": "a2a"}),
                       ("mixtral-8x7b", {}), ("mixtral-8x7b", {"moe_tp": False})]:
        jc = dataclasses.replace(jax_config(name), **over)
        tc_ = dataclasses.replace(get_config(name), **over)
        for opts in (dict(), dict(act_seq=True)):
            assert L.moe_mode(tc_, default_rules(tm, **opts)) == \
                JL.moe_mode(jc, jax_rules(jm, **opts)), (name, over, opts)
        assert L.moe_mode(tc_, default_rules(None)) == "local"


def test_backend_is_a_function_of_the_layout():
    assert comm.layout("cpu", 4, 0) == ("gloo", "direct")
    assert comm.layout("cuda", 4, 4) == ("nccl", "direct")
    assert comm.layout("cuda", 4, 8) == ("nccl", "direct")
    assert comm.layout("cuda", 4, 1) == ("gloo", "host")
    assert [comm.rank_device("cuda", r, 1).index for r in range(4)] == [0] * 4
    assert [comm.rank_device("cuda", r, 4).index for r in range(4)] == [0, 1, 2, 3]


def test_mesh_coordinates_are_row_major_and_outer_major():
    m = comm.Mesh.abstract((2, 3, 2), ("pod", "data", "model"))
    assert m.coords(7) == (1, 0, 1)
    assert m.index(("pod", "data"), 7) == 3
    assert m.index(("pod", "model"), 7) == 3
    assert m.index("model", 7) == 1
    assert m.axis_size(("data", "model")) == 6
    with pytest.raises(ValueError, match="mesh's order"):
        m.index(("model", "pod"), 0)
    with pytest.raises(RuntimeError, match="abstract"):
        m.group("data")


@pytest.mark.parametrize("name", ["mamba2-370m", "llama-3.2-vision-11b"])
def test_unported_sublayers_refuse_a_mesh_by_name(name):
    """Through ``forward_train`` on a mesh of one rank (every collective
    trivial): the refusal comes from the sublayer (or the context)."""
    cfg = get_smoke_config(name)
    rules = default_rules(comm.Mesh.abstract((1, 1), ("data", "model")))
    params = init_params(lm.model_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    what = "Mamba2 sublayer" if cfg.family == "ssm" else "vlm family's context"
    with pytest.raises(NotImplementedError, match=what):
        lm.forward_train(params, tokens, cfg, None if cfg.family == "ssm"
                         else torch.zeros((2, 16, cfg.d_ctx)), rules)


def test_sublayer_refusals_name_their_layer():
    rules = default_rules(comm.Mesh.abstract((1, 2), ("data", "model")))
    x = torch.zeros((1, 2, 64))
    cfg = get_smoke_config("seamless-m4t-large-v2")
    with pytest.raises(NotImplementedError, match="cross-attention sublayer"):
        L.xattn_layer({}, x, x, cfg, rules=rules)
    with pytest.raises(NotImplementedError, match="Mamba2 sublayer"):
        L.mamba_layer({}, x, get_smoke_config("mamba2-370m"), rules=rules)


def test_chip_smoke_phase_12_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--only", "dist"],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 2, out.stderr
    assert out.stdout == "" and "runs on a CUDA card" in out.stderr


@pytest.mark.parametrize("module", ["check_dist_moe", "check_dist_ring",
                                    "check_dist_decode", "check_dist_train"])
def test_check_modules_run_on_the_card_unless_asked_for_the_cpu(module):
    """Like every other entry point of the port: ``--device`` defaults to
    cuda, and without a card the launcher refuses before it spawns a rank."""
    import importlib

    from repro_torch.testing.subproc import rank_parser, run_ranks

    assert rank_parser("x").parse_args([]).device == "cuda"
    assert rank_parser("x").parse_args(["--device", "cpu"]).device == "cpu"
    assert inspect.signature(run_ranks).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    mod = importlib.import_module(f"repro_torch.testing.{module}")
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        mod.main([])
