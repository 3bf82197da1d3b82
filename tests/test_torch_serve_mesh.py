"""Serving on a (2, 2, 2) (pod, data, model) process mesh (8 gloo ranks on
the CPU) against the JAX package: the port's twins of
``repro.testing.check_serve_topology`` and ``check_serve_paged``
(``testing/check_serve_topology.py``, ``testing/check_serve_paged.py``),
every assertion of the reference's checks on every rank; their token
streams equal to the JAX package's single-device ``ServingEngine`` for the
same requests (llama3-8b's smoke model from the JAX initialiser's
weights); the topology engine's logits (a rank decodes 2 of the 4 slots)
within ``check_dist_decode``'s f32 limits of the blind engine's, the paged
engines' within the same limits of the dense one's.  Also the units of
``pod_local_cache_rules`` and ``prefix_key`` (the twins of
``tests/test_serve_topology.py``) and the engines' placements on an
abstract mesh."""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules as jax_rules
from repro.parallel.sharding import init_params as jax_init
from repro.serve import PagedServeConfig as JPagedServeConfig
from repro.serve import PagedServingEngine as JPagedServingEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.serve.engine import pod_local_cache_rules, prefix_key
from repro_torch.testing import check_serve_paged as csp
from repro_torch.testing import check_serve_topology as cst
from repro_torch.testing.subproc import run_ranks
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


@pytest.fixture(scope="module")
def topo_runs():
    d = run_ranks("repro_torch.testing.check_serve_topology", cst.RANKS, device="cpu",
                  timeout=300)
    return cst.assemble(d)


@pytest.fixture(scope="module")
def paged_runs():
    d = run_ranks("repro_torch.testing.check_serve_paged", csp.RANKS, device="cpu",
                  timeout=300)
    return cst.assemble(d)


def _jax_engine_streams(prompts, new, paged=None):
    """The JAX package's single-device engine over the same requests (in
    the reference check's phases for the dense one)."""
    cfg = jax_smoke_config(cst.ARCH)
    params = jax_init(jlm.model_defs(cfg), jax.random.key(0))
    rules = jax_rules(None)
    reqs = [JRequest(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    if paged is None:
        eng = JServingEngine(cfg, params, rules, JServeConfig(max_batch=4, max_seq=64))
        for r in reqs[:3]:
            eng.submit(r)
        eng.run()
        eng.submit(reqs[3])
        eng.run()
    else:
        eng = (JServingEngine(cfg, params, rules, JServeConfig(max_batch=4, max_seq=64))
               if paged == "dense" else
               JPagedServingEngine(cfg, params, rules, JPagedServeConfig(
                   max_batch=4, max_seq=64, block_tokens=8, n_blocks=32)))
        for r in reqs:
            eng.submit(r)
        eng.run()
    return {r.rid: list(r.out) for r in reqs}


def test_topology_check_passes_on_every_rank(topo_runs):
    """Placement (no cache leaf over `pod`; `data` and `model` cut it),
    affinity, equal streams, blind-vs-aware logits, each rank's calls ==
    ``serve_launches``."""
    out = cst.check(topo_runs)
    assert out["blind_vs_aware_limit_use"] <= 1.0


@pytest.mark.parametrize("tag", ["blind", "aware"])
def test_topology_streams_equal_the_jax_engine(topo_runs, tag):
    want = _jax_engine_streams(cst.prompts("smoke"), cst.SIZES["smoke"][2])
    got = topo_runs[0][tag]["streams"]
    assert {rid: out for rid, (_, out) in got.items()} == want


def test_topology_engine_places_the_repeat_in_pod_1(topo_runs):
    a, b = topo_runs[0]["aware"]["streams"], topo_runs[0]["blind"]["streams"]
    assert [a[i][0] for i in range(3)] == [0, 1, 2]
    assert b[3][0] == 0 and a[3][0] in (2, 3)
    # the topology engine's ranks hold 2 of the 4 slots each, by `data`
    rows = {r: res["aware"]["slot_rows"] for r, res in enumerate(topo_runs)}
    assert rows == {r: ((r // 2) % 2 * 2, (r // 2) % 2 * 2 + 2) for r in range(8)}
    assert all(res["blind"]["slot_rows"] == (0, 4) for res in topo_runs)


def test_paged_check_passes_on_every_rank(paged_runs):
    """Equal dense/paged/chunked streams, shared hits and COW copies, the
    allocator quiescent and the zero block zero on every rank, chunked
    prefill, the router's affinity, the calls == ``serve_launches``."""
    out = csp.check(paged_runs)
    assert max(out["limit_use_vs_dense"].values()) <= 1.0


@pytest.mark.parametrize("tag", ["dense", "paged", "chunked"])
def test_paged_streams_equal_the_jax_engine(paged_runs, tag):
    new = csp.PAGED["smoke"][3]
    want = _jax_engine_streams(csp.prompts("smoke"), new, paged="paged")
    assert paged_runs[0][tag]["streams"] == want
    assert _jax_engine_streams(csp.prompts("smoke"), new, paged="dense") == want


def test_the_pool_is_cut_over_the_kv_heads(paged_runs):
    assert all(res[t]["pool_axes"] == {"model"} for res in paged_runs
               for t in ("paged", "chunked"))


def test_pod_local_cache_rules_strip_outer_level():
    topo = cst.topology()
    rules = ShardingRules(None, None)
    assert pod_local_cache_rules(rules, topo) is rules

    class FakeMesh:                      # only identity is inspected here
        pass

    src = ShardingRules(FakeMesh(), {"batch": ("pod", "data"), "kv": "model",
                                     "cache_seq": "pod", "act_seq": None})
    got = pod_local_cache_rules(src, topo)
    assert got.rules["batch"] == "data"
    assert got.rules["kv"] == "model"
    assert got.rules["cache_seq"] is None
    assert got.rules["act_seq"] is None


def test_pod_local_cache_rules_equal_the_reference():
    from repro.serve import pod_local_cache_rules as jrules
    from repro.topology import Topology as JTopology
    from repro.parallel.sharding import ShardingRules as JRules

    jt = JTopology.from_levels([("pod", 2, 8.0), ("data", 2, 4.0), ("model", 2, 2.0)])
    for rr in ({"batch": ("pod", "data"), "fsdp": ("pod", "data"), "kv": "model",
                "model": "model", "cache_seq": "pod", "act_seq": None},
               {"batch": None, "fsdp": "pod", "kv": None, "model": ("pod", "model")}):
        got = pod_local_cache_rules(ShardingRules(object(), rr), cst.topology())
        assert got.rules == jrules(JRules(object(), rr), jt).rules


def test_prefix_key_buckets_prompt_head():
    from repro.serve import prefix_key as jkey

    a = np.arange(32, dtype=np.int32)
    b = np.concatenate([np.arange(16, dtype=np.int32), np.full(8, 7, np.int32)])
    assert prefix_key(a) == prefix_key(b)
    assert prefix_key(a) != prefix_key(a + 1)
    assert prefix_key(a) == jkey(a) and prefix_key(np.arange(5)) == jkey(np.arange(5))


def test_engine_placements_on_an_abstract_mesh():
    """The cache rules the engines derive, read without ranks: the blind
    engine's slots whole, the topology engine's cut over `data`, `pod`
    never, and the kv heads over `model`."""
    from repro_torch.models import lm
    from repro_torch.parallel.comm import Mesh
    from repro_torch.params import tree_leaves
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.testing import train_checks as tc

    cfg = cst.config("smoke")
    mesh = Mesh.abstract(cst.MESH, cst.NAMES)
    rules = cst.rules_for(mesh, cfg)
    model = lm.Model(cfg, tc.smoke_params(cst.ARCH))
    scfg = ServeConfig(max_batch=4, max_seq=64)
    blind = ServingEngine(model, scfg, rules=rules, device="cpu")
    aware = ServingEngine(model, scfg, rules=rules, topology=cst.topology(), device="cpu")
    # (period, slot, position, kv head, head dim)
    assert {s for s in tree_leaves(blind.cache_specs)} == {((), (), (), ("model",), ())}
    assert {s for s in tree_leaves(aware.cache_specs)} == \
        {((), ("data",), (), ("model",), ())}
    assert aware.n_pods == 2 and [aware.slot_pod(s) for s in range(4)] == [0, 0, 1, 1]
    assert tree_leaves(aware.cache)[0].shape[1] == 2
    assert aware.step_rules.rules["fsdp"] == ("pod", "data")


def test_traffic_mesh_arm_needs_eight_ranks():
    """``serve.traffic`` serves on the (2, 2, 2) mesh only in a process
    group of 8 ranks (the reference's arm with 8 devices); alone, none."""
    from repro_torch.serve import traffic

    assert traffic.mesh_arm(cst.config("smoke"), "cpu") == (None, None)
