"""The port's dry run (``repro_torch.launch.dryrun``) and perf strategies
(``launch.perf``) on the CPU.  The llama3-8b smoke cell (train, prefill,
decode) on a (data 2, model 2) mesh over the fake process group is held
three ways: its per-rank argument bytes equal the JAX package's
``memory_analysis().argument_size_in_bytes`` of the same cell and mesh (the
JAX side in a subprocess of 4 fake XLA devices on an Auto-axis mesh), its
matmul FLOPs equal the analytic count from the config, and its collectives
equal the counts the rule table implies."""
import collections
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import perf
from repro_torch.launch.specs import SHAPES, ShapeSpec, input_specs, skip_reason
from repro_torch.models import lm
from repro_torch.parallel.sharding import local_shape, param_placements
from repro_torch.topology import Topology

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")
TOPO = Topology(2, 2, hierarchy="two-level", cluster_axis="data", lane_axis="model")

#: the JAX package's dry run of the same cells (repro.launch.dryrun.lower_cell
#: on an Auto-axis (2, 2) mesh of 4 fake devices: make_mesh's Explicit axes
#: fail on jax 0.9); prints each cell's argument bytes, HLO FLOPs and bytes
JAX_SIDE = """
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.launch import dryrun as dr
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = get_smoke_config("llama3-8b")
out = {}
for kind in sys.argv[1:]:
    _, compiled = dr.lower_cell(cfg, ShapeSpec("t", 64, 4, kind), mesh)
    out[kind] = int(compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_args():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    out = subprocess.run([sys.executable, "-c", JAX_SIDE, *KINDS], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    cfg = get_smoke_config("llama3-8b")
    out = {}
    with dr.fake_world(4):
        mesh = dr.fake_mesh((2, 2), ("data", "model"))
        for kind in KINDS:
            shape = ShapeSpec("t", 64, 4, kind)
            out[kind] = (dr.run_cell(cfg, shape, mesh), dr.build_rules(cfg, shape, mesh))
    return cfg, out


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_equal_the_jax_packages(jax_args, cells, kind):
    _, runs = cells
    assert runs[kind][0]["arg_bytes"] == jax_args[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_matmul_flops_equal_the_analytic_count(cells, kind):
    """Per rank (2 of the batch's 4 rows, 1 of 2 model shards): the
    projections and the vocab head cut over `model`; attention's two
    products over the rank's heads (prefill, train) or over the rank's
    cache slots of every head (the decode cache cut over `model`); the
    backward makes two products a forward product, and the plain
    attention's backward five (it recomputes the scores)."""
    cfg, runs = cells
    d, H, Hkv, hd, L = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    ms, B, S, V = 2, 2, 64, cfg.padded_vocab
    proj = (d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * cfg.d_ff) / ms
    if kind == "decode":
        mm = 2 * B * proj * L + 2 * B * d * V / ms
        attn = L * 2 * 2 * B * H * (S // ms) * hd
    else:
        T = B * S
        fwd = 2 * T * proj * L
        head = 2 * (T if kind == "train" else B) * d * V / ms
        attn_fwd = L * 2 * 2 * B * (H // ms) * S * S * hd
        mm = 3 * (fwd + head) if kind == "train" else fwd + head
        attn = 3.5 * attn_fwd if kind == "train" else attn_fwd
    assert runs[kind][0]["matmul_flops"] == mm + attn
    assert runs[kind][0]["flops"] == runs[kind][0]["matmul_flops"]


def _fsdp_gathers(cfg, rules) -> collections.Counter:
    """The ZeRO-3 all-gathers the rule table implies: every period leaf cut
    over `data` gathered once a period, its result the leaf's block whole
    over `data`."""
    mesh = rules.mesh
    defs, specs = lm.model_defs(cfg)["period"], param_placements(lm.model_defs(cfg), rules)["period"]
    out = collections.Counter()

    def walk(dn, sp):
        if isinstance(dn, dict):
            for k in dn:
                walk(dn[k], sp[k])
            return
        spec = sp[1:]                       # one period's slice
        if not any("data" in axes for axes in spec):
            return
        whole = tuple(tuple(a for a in axes if a != "data") for axes in spec)
        n = math.prod(local_shape(dn.shape[1:], whole, mesh)) * dn.dtype.itemsize
        out[("all-gather", (0, 2), n)] += cfg.n_periods
    walk(defs, specs)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_collectives_are_the_rule_tables(cells, kind):
    """The ZeRO-3 gathers over `data` (and, in the backward, their
    reduce-scatters), and a tensor-parallel layer's two all-reduces over
    `model` (plus the vocab-sharded lookup's), priced on the inner level."""
    cfg, runs = cells
    run, rules = runs[kind]
    recs = collections.Counter((r["kind"], r["members"], r["bytes"]) for r in run["records"])
    gathers = _fsdp_gathers(cfg, rules)
    assert gathers and {k: recs[k] for k in gathers} == dict(gathers)
    if kind == "train":
        scatters = {("reduce-scatter", m, n // 2): c for (_, m, n), c in gathers.items()}
        assert {k: recs[k] for k in scatters} == scatters
    B, S = 2, 1 if kind == "decode" else 64
    act = B * S * cfg.d_model * 4
    tp = recs[("all-reduce", (0, 1), act)]
    # two a layer and the lookup's; the backward sums each of their inputs'
    # gradients once more; a decode step over the cut cache also sums each
    # layer's attention output partials (o) over `model`
    want = {"prefill": 2 * cfg.n_layers + 1, "train": 2 * (2 * cfg.n_layers + 1),
            "decode": 3 * cfg.n_layers + 1}[kind]
    assert tp == want
    if kind == "prefill":
        ar = [r for r in run["records"] if r["kind"] == "all-reduce"]
        from repro_torch.roofline.analysis import collective_level_bytes
        lv = collective_level_bytes(ar, TOPO)
        assert lv["intra"] == tp * 2 * (1 / 2) * act and lv["inter"] == 0.0


def test_analyse_cell_keeps_the_reference_keys():
    cfg = get_smoke_config("llama3-8b")
    rec = dr.analyse(cfg, ShapeSpec("t", 64, 4, "train"), TOPO, "smoke2x2")
    for key in ("arch", "shape", "mesh", "devices", "kind", "topology", "n_microbatches",
                "mem_per_device", "fits_80gib_hbm", "per_device", "roofline",
                "model_flops_global", "model_vs_hlo_flops"):
        assert key in rec, key
    r = rec["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck",
                "step_s_lower_bound", "collective_s_by_level", "collective_s_flat_hw",
                "memory_s_hlo_upper", "exposed_collective_s", "step_s_overlap_aware",
                "mfu_upper_bound"):
        assert key in r, key
    assert rec["n_microbatches"] == 1 and rec["devices"] == 4
    assert rec["mem_per_device"]["arguments_gib"] * 2 ** 30 == 618756
    assert r["collective_s"] == pytest.approx(sum(r["collective_s_by_level"].values()))


def test_one_card_cells_run_without_a_process_group():
    import torch.distributed as dist
    cfg = get_smoke_config("llama3-8b")
    rec = dr.analyse(cfg, ShapeSpec("d", 64, 4, "decode"), None, "one-card")
    assert not dist.is_initialized()
    assert rec["devices"] == 1 and rec["per_device"]["wire_bytes"] == 0.0
    assert rec["roofline"]["collective_s"] == 0.0


def test_a_process_with_a_group_is_refused():
    import torch.distributed as dist
    with dr.fake_world(2):
        with pytest.raises(RuntimeError, match="process of its own"):
            with dr.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_shapes_and_skips_are_the_references():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget, list_archs
    from repro_torch.configs import get_config
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind) for k, v in JSHAPES.items()}
    for arch in list_archs():
        for s in SHAPES:
            assert skip_reason(get_config(arch), s) == jget(arch).skip_shapes.get(s)
    cfg = get_smoke_config("seamless-m4t-large-v2")
    spec = input_specs(cfg, SHAPES["prefill_32k"])
    assert spec["ctx"].device.type == "meta" and spec["tokens"].shape == (32, 32768)


@pytest.mark.parametrize("strategy", perf.STRATEGIES)
def test_every_strategy_runs_through_analyse_cell(strategy):
    topo = perf.parse_launch_topology("2x2x2:three-level")
    arch = "mixtral-8x7b" if strategy == "moe_a2a" else "llama3-8b"
    rec = perf.analyse(arch, "train_4k", strategy, topology=topo, smoke=True)
    assert rec["strategy"] == strategy and rec["devices"] == 8
    coll = rec["collectives"]
    if strategy == "moe_a2a":
        assert coll.get("all-to-all", 0) > 0
    if strategy in ("fsdp_pure", "fsdp_hier", "fsdp_hier_ov", "nm1"):
        assert rec["n_microbatches"] == 1
    if strategy == "fsdp_pure":
        assert coll.get("all-reduce", 0) < 1e6       # no tensor-parallel sums
    assert set(rec["roofline"]["collective_s_by_level"]) == {"pod", "inter", "intra"}


def test_dryrun_cli_writes_records_and_skips(tmp_path, capsys):
    assert dr.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--shape", "long_500k",
                    "--topology", "2x2", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "llama3-8b__decode_32k__topo2x2-two-level.json").read_text())
    assert rec["devices"] == 4 and rec["fits_80gib_hbm"] in (True, False)
    skipped = json.loads((tmp_path / "llama3-8b__long_500k__topo2x2-two-level.json").read_text())
    assert "quadratic" in skipped["skipped"]
    assert "all requested dry-run cells passed" in capsys.readouterr().out
