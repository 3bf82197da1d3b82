"""The port's cycle model (``repro_torch.sim``) against the JAX package's
``repro.sim``: the traces of ``build_trace`` for the six kernels and of the
``isa_kernels`` programs run on ``TraceMachine`` equal record for record;
``simulate``'s results equal as floats, with overlap off and on, at 8, 16,
32 and 64 lanes, flat and two-level, and with interface cuts; the PPA
functions and the paper's constants equal; and every assertion of the
reference's paper-validation tests (``tests/test_sim_paper.py``) holds
against the port's sim (the same test functions, their imports pointed at
``repro_torch.sim``)."""
import dataclasses
import pathlib

import pytest

from repro import sim as jsim
from repro.core import isa_kernels as jkernels
from repro.sim import paper as jpaper
from repro.sim import ppa as jppa
from repro_torch import sim
from repro_torch.core import isa_kernels
from repro_torch.sim import paper, ppa
from repro_torch.testing import check_core as cc
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

KERNELS = tuple(sim.KERNEL_BUILDERS)
#: the builders' sizes for the equality sweep (the defaults' loops, shorter)
SMALL = {"fmatmul": {"M": 16, "K": 16}, "fconv2d": {"rows": 12},
         "jacobi2d": {"rows": 12}, "softmax": {"rows": 8},
         "fdotproduct": {}, "exp": {}}


def _records(trace):
    return [(r.op, r.vl, r.unit, r.flops_per_elem, r.meta) for r in trace]


def _params(pkg, lanes, hierarchy, cuts):
    p = pkg.araxl_params(lanes, hierarchy=hierarchy)
    return p.with_cuts(1, 1, 1) if cuts else p


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("lanes", [8, 64])
def test_build_trace_equals_the_reference(kernel, lanes):
    for hierarchy in ("flat", "two-level"):
        got = sim.build_trace(kernel, sim.araxl_params(lanes, hierarchy=hierarchy), 128)
        want = jsim.build_trace(kernel, jsim.araxl_params(lanes, hierarchy=hierarchy),
                                128)
        assert _records(got) == _records(want)


@pytest.mark.parametrize("kernel", KERNELS)
def test_isa_programs_on_trace_machines_equal_the_reference(kernel):
    """The port's program on the port's TraceMachine, the reference's on
    its own: the same records (dependencies and slide levels included)."""
    args = cc.program_inputs(4)[kernel]
    got = sim.TraceMachine(topology=sim.araxl_params(16).topology)
    want = jsim.TraceMachine(topology=jsim.araxl_params(16).topology)
    isa_kernels.KERNELS[kernel](got, *args)
    jkernels.KERNELS[kernel](want, *args)
    assert len(got.trace) >= 4
    assert _records(got.trace) == _records(want.trace)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("lanes", [8, 16, 32, 64])
def test_simulate_equals_the_reference(kernel, lanes):
    for hierarchy in ("flat", "two-level"):
        for cuts in (False, True):
            p = _params(sim, lanes, hierarchy, cuts)
            jp = _params(jsim, lanes, hierarchy, cuts)
            assert p.topology.describe() == jp.topology.describe()
            assert p.red_tree_lat() == jp.red_tree_lat()
            tr = sim.build_trace(kernel, p, 128, **SMALL[kernel])
            jtr = jsim.build_trace(kernel, jp, 128, **SMALL[kernel])
            for overlap in (False, True):
                got = sim.simulate(tr, p, overlap=overlap)
                want = jsim.simulate(jtr, jp, overlap=overlap)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (hierarchy, cuts, overlap)
                assert (got.utilization, got.flop_per_cycle) == \
                    (want.utilization, want.flop_per_cycle)


def test_params_equal_the_reference():
    for lanes in (1, 2, 8, 16, 64, 128):
        for pods in (None, 2):
            if pods and lanes < 8:
                continue
            got = sim.araxl_params(lanes, n_pods=pods)
            want = jsim.araxl_params(lanes, n_pods=pods)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.topology.describe() == want.topology.describe()
            assert (got.red_tree_lat(), got.glsu_lat, got.vlmax) == \
                (want.red_tree_lat(), want.glsu_lat, want.vlmax)
            for hops in (1, 3, 9):
                assert got.slide_cost(hops) == want.slide_cost(hops)
    assert dataclasses.asdict(sim.ara2_params(8)) == \
        dataclasses.asdict(jsim.ara2_params(8))
    for k in KERNELS:
        for n in (8, 64):
            assert sim.kernels.max_perf_flop_per_cycle(k, n) == \
                jsim.kernels.max_perf_flop_per_cycle(k, n)


def test_ppa_and_paper_constants_equal_the_reference():
    for lanes in (8, 16, 32, 64):
        p, jp = sim.araxl_params(lanes), jsim.araxl_params(lanes)
        assert ppa.area_breakdown_kge(p) == jppa.area_breakdown_kge(jp)
        for f in ("area_mm2", "power_w", "interface_area_fraction"):
            assert getattr(ppa, f)(p) == getattr(jppa, f)(jp), f
        for f in ("peak_gflops", "energy_eff_gflops_per_w",
                  "area_eff_gflops_per_mm2"):
            assert getattr(ppa, f)(p, 0.97) == getattr(jppa, f)(jp, 0.97), f
    for c in (1, 2, 4, 16):
        for f in ("glsu_kge", "ringi_kge", "reqi_kge"):
            assert getattr(ppa, f)(c) == getattr(jppa, f)(c)
    mine = {k: v for k, v in vars(paper).items() if k.isupper()}
    theirs = {k: v for k, v in vars(jpaper).items() if k.isupper()}
    assert mine == theirs and len(mine) >= 19


def _paper_tests():
    """The reference's paper-validation test functions, compiled with their
    ``repro.sim`` imports pointed at the port's sim: (name, kwargs) cases,
    their parametrisations expanded, and the namespace."""
    path = pathlib.Path(__file__).with_name("test_sim_paper.py")
    src = path.read_text().replace("from repro.sim", "from repro_torch.sim")
    assert "repro.sim" not in src.replace("repro_torch.sim", "")
    ns = {"__name__": "test_sim_paper_on_the_port"}
    exec(compile(src, f"{path} (on repro_torch.sim)", "exec"), ns)
    cases = []
    for name, fn in ns.items():
        if not (name.startswith("test_") and callable(fn)):
            continue
        params = [{}]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name == "parametrize":
                argnames, values = mark.args[:2]
                argnames = [a.strip() for a in argnames.split(",")] \
                    if isinstance(argnames, str) else list(argnames)
                params = [{**p, **dict(zip(argnames, v if len(argnames) > 1
                                           else (v,)))}
                          for p in params for v in values]
        cases += [(name, kw) for kw in params]
    return cases, ns


PAPER_CASES, PAPER_NS = _paper_tests()


def test_the_paper_tests_run_on_the_port():
    assert PAPER_NS["simulate"] is sim.simulate
    assert PAPER_NS["paper"] is paper and PAPER_NS["ppa"] is ppa
    assert len(PAPER_CASES) >= 30


@pytest.mark.parametrize("name,kw", PAPER_CASES,
                         ids=[f"{n}[{','.join(map(str, k.values()))}]"
                              for n, k in PAPER_CASES])
def test_paper_validation_holds_on_the_port(name, kw):
    PAPER_NS[name](**kw)
