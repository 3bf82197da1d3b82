"""The port's analysis (``repro_torch.analysis``): the lint's findings on
crafted sources equal the JAX package's lint where the rule is shared (L3,
L4 and the ``# repro: noqa`` parsing); each rule (L1-L4, S1-S3) fires on a
planted violation and stays quiet on its good twin; and
``python -m repro_torch.analysis`` exits 0 on the tree."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.analysis import lint as jlint
from repro.analysis import schedule_check as jsched
from repro_torch.analysis import RULES, lint, record_check, schedule_check
from repro_torch.launch import dryrun as dr
from repro_torch.parallel import comm
from repro_torch.topology import Topology
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: sources the two lints read alike (the clock and BENCH rules, noqa)
SHARED = {
    "clocks": """\
import time
import timeit
from time import perf_counter as pc

t0 = time.time()
t1 = pc()
t2 = timeit.default_timer()
time.sleep(0)
t3 = time.monotonic()  # repro: noqa(L4)
t4 = time.perf_counter_ns()  # repro: noqa( L3 , L4 )
t5 = time.process_time()  # repro: noqa(L1)
""",
    "bench": """\
import json
import pathlib

pathlib.Path("BENCH_sim.json").write_text("{}")
with open("BENCH_kernels.json", "w") as f:
    json.dump({}, f)
open("notes.json", "w").close()
x = open("BENCH_serve.json").read()
pathlib.Path("BENCH_x.json").write_bytes(b"")  # repro: noqa(L3)
""",
    "aliases": """\
import time as clock
from time import monotonic
import timeit as ti

a = clock.perf_counter()
b = monotonic()
c = ti.default_timer()
""",
}


def _rule_lines(findings, rules):
    return sorted((f.rule, f.line) for f in findings if f.rule in rules)


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_rules_find_what_the_jax_lint_finds(name):
    src = SHARED[name]
    got = lint.lint_source(src, "src/repro_torch/tool/x.py")
    want = jlint.lint_source(src, "src/repro/tool/x.py")
    assert _rule_lines(got, {"L3", "L4"}) == _rule_lines(want, {"L3", "L4"})
    assert got, "the crafted source must give findings"


def test_noqa_parsing_is_the_references():
    for text in ("x = 1  # repro: noqa(L4)", "x  # repro:noqa(L1,L4)",
                 "y  #  repro:  noqa( L2 , L3 )", "z  # noqa(L4)", "w"):
        assert lint._noqa_map(text) == jlint._noqa_map(text)


def test_the_sanctioned_clock_module_is_allowed():
    src = "import time\nt = time.perf_counter()\n"
    assert lint.lint_source(src, "src/repro_torch/testing/timing.py") == []
    assert [f.rule for f in lint.lint_source(src, "chip_smoke.py")] == ["L4"]
    façade = "from repro_torch.testing import timing as time\nt = time.monotonic()\n"
    assert lint.lint_source(façade, "src/repro_torch/ft/x.py") == []


L1_BAD = """\
import torch.distributed as dist
from torch.distributed import all_gather

def step(x, g):
    dist.all_reduce(x, group=g)
    dist.barrier()
    return dist.batch_isend_irecv([])
"""


def test_l1_bans_collectives_outside_comm():
    got = lint.lint_source(L1_BAD, "src/repro_torch/models/x.py")
    assert [(f.rule, f.line) for f in got] == [("L1", 2), ("L1", 5), ("L1", 7)]
    assert lint.lint_source(L1_BAD, "src/repro_torch/parallel/comm.py") == []
    assert lint.lint_source(L1_BAD, "src/repro_torch/testing/nccl_probe.py") == []
    good = "from repro_torch.parallel import comm\n\ndef f(x, m):\n    return comm.psum(x, 'model', m)\n"
    assert lint.lint_source(good, "src/repro_torch/models/x.py") == []


L2_BAD = """\
import os
from os import environ

os.environ["CUDA_VISIBLE_DEVICES"] = ""
environ.setdefault("OMP_NUM_THREADS", "1")
del os.environ["X"]
os.putenv("Y", "1")


def test_it(monkeypatch):
    os.environ["Z"] = "1"
"""


def test_l2_bans_import_time_env_mutation_in_the_ports_tests():
    got = lint.lint_source(L2_BAD, "tests/test_torch_x.py")
    assert [(f.rule, f.line) for f in got] == [("L2", 4), ("L2", 5), ("L2", 6), ("L2", 7)]
    assert lint.lint_source(L2_BAD, "tests/torch_helper.py") != []
    assert lint.lint_source(L2_BAD, "tests/conftest.py") == []
    assert lint.lint_source(L2_BAD, "src/repro_torch/launch/x.py") == []


def test_l3_and_l4_fire_in_the_port():
    got = lint.lint_source(SHARED["bench"], "src/repro_torch/launch/x.py")
    assert [f.line for f in got if f.rule == "L3"] == [4, 5]
    got = lint.lint_source(SHARED["clocks"], "tests/test_torch_x.py")
    assert [f.line for f in got if f.rule == "L4"] == [5, 6, 7, 11]


def test_each_lint_rule_finds_its_planted_violation(tmp_path):
    """A scratch tree holding one violation of each rule: ``lint_repo``
    sweeps the port's places and finds each."""
    files = {"src/repro_torch/models/bad.py": L1_BAD,
             "tests/test_torch_bad.py": L2_BAD,
             "src/repro_torch/launch/bench.py": SHARED["bench"],
             "chip_smoke.py": SHARED["clocks"],
             "src/repro_torch/parallel/comm.py": L1_BAD,
             "tests/test_other.py": L2_BAD}
    for rel, src in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(src)
    got = lint.lint_repo(tmp_path)
    by = {(f.rule, f.path) for f in got}
    assert {("L1", "src/repro_torch/models/bad.py"), ("L2", "tests/test_torch_bad.py"),
            ("L3", "src/repro_torch/launch/bench.py"), ("L4", "chip_smoke.py")} <= by
    assert not any(p in ("src/repro_torch/parallel/comm.py", "tests/test_other.py")
                   for _, p in by)


def test_the_tree_lints_clean():
    assert lint.lint_repo(ROOT) == []


# -- S1, S2, S3 ----------------------------------------------------------------

TOPO3 = Topology.from_levels([("pod", 2, 8.0), ("data", 2, 4.0), ("model", 2, 2.0)])


def test_s1_fires_on_groups_the_topology_cannot_price():
    ok = [{"kind": "all-reduce", "bytes": 8, "group": 2, "members": (0, 1)},
          {"kind": "all-gather", "bytes": 8, "group": 4, "members": (0, 2, 4, 6)}]
    assert record_check.check_collective_pricing(ok, TOPO3, "e") == []
    bad = [{"kind": "all-reduce", "bytes": 8, "group": 3, "members": (0, 1, 2)},
           {"kind": "all-gather", "bytes": 8, "group": 2, "members": (6, 9)}]
    got = record_check.check_collective_pricing(bad, TOPO3, "e")
    assert [f.rule for f in got] == ["S1", "S1"]
    assert "subgrid" in got[0].message and "past the topology" in got[1].message


@pytest.mark.parametrize("perm,n", [
    ([(0, 1), (1, 2), (2, 3), (3, 0)], 4), ([(0, 2), (1, 3), (2, 0), (3, 1)], 4),
    ([(0, 1), (1, 0)], 2), ([(0, 1), (1, 2)], 3), ([(0, 1), (1, 1)], 2),
    ([(0, 0), (1, 1)], 2), ([(0, 1), (1, 3), (2, 0), (3, 2)], 4), ([(0, 5)], 4),
    ([(0, 1), (0, 2)], 3)])
def test_ring_permutation_check_is_the_references(perm, n):
    assert schedule_check.check_ring_permutation(perm, n) == \
        jsched.check_ring_permutation(perm, n)


def test_s2_fires_on_a_broken_shift_and_not_on_comms():
    with dr.fake_world(4):
        mesh = dr.fake_mesh((1, 4), ("data", "model"))
        comm.ppermute_shift(torch.zeros(4), "model", 1, mesh)
        comm.ppermute_shift(torch.zeros(4), "model", 2, mesh)
    assert schedule_check.check_permute_records(mesh.records, "e") == []
    bad = dict(mesh.records[0], pairs=((1, 0), (2, 1), (3, 3), (0, 2)))
    got = schedule_check.check_permute_records([bad], "e")
    assert [f.rule for f in got] == ["S2"] and "non-uniform" in got[0].message
    partial = dict(mesh.records[0], pairs=((1, 0), (2, 1)))
    assert "partial ring" in schedule_check.check_permute_records([partial], "e")[0].message


def test_s3_fires_on_a_plan_past_the_cards_limits():
    assert record_check.check_kernel_budget() == []
    bad = [("matmul", (128, 4096, 4096), "bfloat16", {"splits": 64}),
           ("paged_attention", (8, 32, 8, 1024, 128), "bfloat16", {"bt": 128, "splits": 1}),
           ("rmsnorm", (4, 4096), "bfloat16", {"bwd_blocks": 9}),
           ("reduction", (4096,), "float32", {"blocks": 5000})]
    got = record_check.check_kernel_budget(bad)
    assert [f.rule for f in got] == ["S3"] * 4


def test_rules_are_the_references_names():
    from repro.analysis import RULES as JRULES
    assert set(RULES) == set(JRULES)


def test_the_cli_exits_zero_on_the_tree():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "clean (L1, L2, L3, L4, S1, S2, S3 active)" in out.stdout
