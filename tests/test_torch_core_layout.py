"""The AraXL machine's layout and a one-lane machine, against the JAX
package: the index maps and host oracles, ``VectorMachineSpec``'s
geometry, ``valid_mask``, ``global_index_grid`` and ``_pad_len`` rank by
rank on (1, 1), (2, 4), (4, 2) and (2, 2, 2) (the port's column of each
rank, from a mesh with no process group, assembled in ring order), and a
one-lane machine on the CPU driven through every instruction against the
JAX (1, 1) machine (an Auto-axis mesh, f64, under ``jax.jit``) with its
trace records equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import glsu as jglsu
from repro.core import layout as jlayout
from repro.core.isa import AraXLMachine as JMachine
from repro.testing.x64 import x64_mode
from repro_torch.core import glsu, layout, make_machine
from repro_torch.core.isa import AraXLMachine
from repro_torch.parallel.comm import Mesh
from repro_torch.testing import check_core as cc
from repro_torch.topology import parse_topology

import torch_core_jax as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

GRIDS = ("1x1", "2x4", "4x2", "2x2x2")


def _specs(grid: str) -> list:
    """The port's spec at every rank of ``grid`` (ring order)."""
    topo = parse_topology(grid)
    names = tuple(l.axis for l in topo.levels)
    return [layout.VectorMachineSpec(Mesh(names, topo.shape, rank=r),
                                     topo.cluster_axis, topo.lane_axis, 4096, 64,
                                     topology=topo)
            for r in range(topo.n_lanes)]


@pytest.mark.parametrize("C,L", [(1, 1), (2, 4), (4, 2), (8, 1), (1, 8), (4, 4)])
def test_index_maps_equal_the_reference(C, L):
    i = np.arange(C * L * 5)
    for got, want in zip(layout.element_to_coords(i, C, L),
                         jlayout.element_to_coords(i, C, L)):
        np.testing.assert_array_equal(got, want)
    b, c, l = jlayout.element_to_coords(i, C, L)
    np.testing.assert_array_equal(layout.coords_to_element(b, c, l, C, L),
                                  jlayout.coords_to_element(b, c, l, C, L))
    x = np.random.default_rng(0).normal(size=C * L * 5)
    reg = layout.mem_to_striped_host(x, C, L)
    np.testing.assert_array_equal(reg, jlayout.mem_to_striped_host(x, C, L))
    np.testing.assert_array_equal(glsu.mem_to_reg_host(x, C, L),
                                  jglsu.mem_to_reg_host(x, C, L))
    np.testing.assert_array_equal(layout.striped_to_mem_host(reg), x)
    np.testing.assert_array_equal(glsu.reg_to_mem_host(reg),
                                  jglsu.reg_to_mem_host(reg))


def test_staged_rounds_equal_the_reference():
    for n in range(1, 129):
        assert glsu.n_staged_rounds(n) == jglsu.n_staged_rounds(n)


@pytest.mark.parametrize("grid", GRIDS)
def test_spec_geometry_equals_the_reference(grid):
    want = J.jax_spec(grid)
    for s in _specs(grid):
        assert (s.n_clusters, s.n_lanes, s.n_total_lanes, s.vlen_elems) == \
            (want.n_clusters, want.n_lanes, want.n_total_lanes, want.vlen_elems)
        assert s.ring_axes == want.ring_axes
        assert s.cluster_axes == want.cluster_axes and s.lane_axes == want.lane_axes
        assert s.topology_levels() == want.topology_levels()
        assert [s.padded_vl(v) for v in range(1, 300)] == \
            [want.padded_vl(v) for v in range(1, 300)]
        assert s.topology.describe() == want.topology.describe()
    assert [s.ring_pos for s in _specs(grid)] == list(range(want.n_total_lanes))


def test_spec_refuses_a_topology_of_another_grid():
    from repro_torch.topology import Topology

    with pytest.raises(ValueError, match="does not match"):
        layout.VectorMachineSpec(Mesh(("cluster", "lane"), (2, 4)),
                                 topology=Topology(4, 2))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("blocked", [False, True], ids=["striped", "blocked"])
def test_valid_mask_and_index_grid_equal_the_reference(grid, blocked):
    jspec = J.jax_spec(grid)
    C, L, n = jspec.n_clusters, jspec.n_lanes, jspec.n_total_lanes
    lay = layout.VectorLayout.BLOCKED if blocked else layout.VectorLayout.STRIPED
    jlay = jlayout.VectorLayout.BLOCKED if blocked else jlayout.VectorLayout.STRIPED
    for B in (1, 3, 8):
        want = np.asarray(jlayout.global_index_grid(jspec, B, jlay))
        cols = [layout.global_index_grid(s, B, lay) for s in _specs(grid)]
        got = (cc.assemble(cols, (C, L)) if not blocked
               else torch.stack(cols).numpy())
        np.testing.assert_array_equal(got, want)
        for vl in (0, 1, B * n // 2 + 1, B * n):
            shape = (B, C, L) if not blocked else (n, B)
            jm = np.asarray(jlayout.valid_mask(
                jspec, jlayout.VReg(jnp.zeros(shape), vl, jlay)))
            cols = [layout.valid_mask(s, layout.VReg(torch.zeros(B), vl, lay))
                    for s in _specs(grid)]
            got = (cc.assemble(cols, (C, L)) if not blocked
                   else torch.stack(cols).numpy())
            np.testing.assert_array_equal(got, jm)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mode", ["staged", "direct"])
def test_pad_len_equals_the_reference(grid, mode):
    jm = JMachine(J.jax_spec(grid), glsu_mode=mode)
    for s in _specs(grid):
        m = AraXLMachine(s, glsu_mode=mode, device="cpu")
        assert [m._pad_len(v) for v in range(1, 600, 7)] == \
            [jm._pad_len(v) for v in range(1, 600, 7)]


CONFIGS = [("staged", "ring"), ("direct", "xla")]


@pytest.fixture(scope="module")
def one_lane():
    """exercise() on the port's one-lane CPU machine and on the JAX (1, 1)
    machine, each configuration: (port outputs, port trace, JAX outputs,
    JAX trace)."""
    inp = cc.inputs(1)
    out = {}
    with x64_mode(True):
        for glsu_mode, red in CONFIGS:
            v = make_machine(1, 1, vlen_bits=4096, glsu_mode=glsu_mode,
                             reduce_mode=red, dtype=torch.float64, trace=[],
                             device="cpu")
            got = cc.as_numpy(cc.to_host(cc.exercise(v, inp, 1)))
            jm = J.jax_machine("1x1", glsu_mode, red, "flat")
            res = jax.jit(lambda i: cc.exercise(jm, i, 1))(inp)
            want = {k: np.asarray(a) for k, a in res.items()}
            out[(glsu_mode, red)] = (got, v.trace, want, jm.trace)
    return out


@pytest.mark.parametrize("cfg", CONFIGS, ids="-".join)
def test_one_lane_machine_holds_the_reference_check(one_lane, cfg):
    cc.check(one_lane[cfg][0], cc.inputs(1), 1, "-".join(cfg))


@pytest.mark.parametrize("cfg", CONFIGS, ids="-".join)
def test_one_lane_machine_equals_the_jax_machine(one_lane, cfg):
    got, _, want, _ = one_lane[cfg]
    for name in ("reg", "reg_y", "reg2", "mask", "brd2", "vid2"):
        np.testing.assert_array_equal(got[name], want[name].reshape(-1),
                                      err_msg=name)
    for name in ("st", "d1", "u1", "merge", "ge", "st2", "quirk", "vadd",
                 "vsub", "vmul", "vdiv", "vmax", "vmin", "addf", "isum",
                 "max", "max2", "cpop", *(f"sd{k}" for k in cc.slide_ks(1))):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    inp = cc.inputs(1)
    for name, prod in (("fma", inp["x"] * inp["y"]), ("fmacc", 1.5 * inp["x"])):
        bound = np.spacing(np.abs(prod)) + np.spacing(np.abs(want[name]))
        assert (np.abs(got[name] - want[name]) <= bound).all(), name
    for name in ("sum", "sum2"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-12)
    np.testing.assert_allclose(got["exp2"], want["exp2"], rtol=1e-14)


@pytest.mark.parametrize("cfg", CONFIGS, ids="-".join)
def test_one_lane_trace_records_equal_the_jax_machine(one_lane, cfg):
    _, got, _, want = one_lane[cfg]
    assert len(got) > 30
    assert J.records(got) == J.records(want)


def test_machine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_machine(1, 1)


def test_a_many_lane_machine_needs_its_ranks():
    with pytest.raises(ValueError, match="pass world="):
        make_machine(2, 4, device="cpu")


def test_quickstart_twin_prints_the_references_lines():
    """``python -m repro_torch.examples.quickstart --device cpu``: eight gloo
    ranks print what the reference's quickstart prints, its simulated
    softmax the reference sim's cycles."""
    import re

    from repro.core import isa_kernels as jkernels
    from repro.sim import TraceMachine, araxl_params, simulate
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    assert "machine: 2 clusters x 4 lanes, VLMAX=1024 elements/vreg" in out
    assert "element 5 sits at (row, cluster, lane) = (0, 1, 1)" in out
    assert "slide1down head: [1. 2. 3. 4. 5. 6.]" in out
    assert "vredsum: 2016.0 expected: 2016.0" in out
    assert float(re.search(r"fmatmul max err: (\S+)", out).group(1)) < 1e-5
    sums = re.search(r"softmax row sums: \[(.*)\]", out).group(1).split()
    assert np.allclose([float(s) for s in sums], 1.0, atol=1e-5)
    tv = TraceMachine()
    jkernels.softmax(tv, np.zeros((4, 64 * 64)))
    want = simulate(tv.trace, araxl_params(64))
    assert f"{want.cycles:.0f} cycles, FPU util {want.utilization:.1%}" in out
