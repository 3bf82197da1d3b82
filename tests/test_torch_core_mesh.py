"""The AraXL machine on a process mesh: eight gloo ranks on the CPU
(``repro_torch.testing.check_core``, spawned once for the file) on (2, 4),
(4, 2) and (2, 2, 2), held to numpy (every assertion of the reference's
``check_core`` and of the machine part of its ``check_topology``, in
every configuration) and to the JAX package's machine, built here on an
Auto-axis mesh (``jax.make_mesh(..., axis_types=(AxisType.Auto,) * k)``:
``repro.core.make_machine``'s Explicit axes fail its own
``with_sharding_constraint`` on this jax) and run under ``jax.jit`` in
f64, for staged/ring on the topology's hierarchy and direct/xla/flat.

Tolerances (f64): loads, stores, slides, ``vbrd``, ``vid``, masks,
``vmerge``, ``vcpop`` and element-wise arithmetic bit-equal;
``vfma`` and ``vfmacc.vf`` within the rounding of their product (XLA's
jit contracts ``a*b + c`` into one FMA, the port's two ops round twice as
the reference's eager ops do: one ulp of the product plus one of the
result); reductions within 1e-12 relative and bit-equal on integer-valued
payloads; ``vexp`` within 1e-14 relative.
"""
import jax
import numpy as np
import pytest

from repro.testing.x64 import x64_mode
from repro_torch.testing import check_core as cc
from repro_torch.testing.subproc import run_ranks
from repro_torch.topology import hier_name

import torch_core_jax as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

WORLD = 8
GRIDS = ("2x4", "4x2", "2x2x2")
#: the configurations held to the JAX machine: (glsu, reduce, hierarchy),
#: None the grid's own hierarchical model
JAX_CONFIGS = (("staged", "ring", None), ("direct", "xla", "flat"))
MOVES = ("st", "d1", "u1", "merge", "ge", "st2", "quirk")
ARITH = ("vadd", "vsub", "vmul", "vdiv", "vmax", "vmin", "addf")
REGS = ("reg", "reg_y", "reg2", "mask", "brd2", "vid2")


def _key(grid, glsu, red, h):
    return (grid, glsu, red, h or hier_name(len(grid.split("x"))))


ALL = [_key(g, *c) for g in GRIDS for c in cc.CONFIGS]
PAIRS = [_key(g, *c) for g in GRIDS for c in JAX_CONFIGS]


def _id(k):
    return "-".join(k)


@pytest.fixture(scope="module")
def ranks():
    d = run_ranks("repro_torch.testing.check_core", WORLD, str(WORLD),
                  "--parts", "core,topology,collectives", device="cpu",
                  timeout=300)
    return cc.load(d, WORLD)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    with x64_mode(True):
        for key in PAIRS:
            v = J.jax_machine(*key)
            n = v.spec.n_total_lanes
            inp = cc.inputs(n)
            res = jax.jit(lambda i: cc.exercise(v, i, n))(inp)
            out[key] = ({k: np.asarray(a) for k, a in res.items()}, list(v.trace))
    return out


def _assembled(ranks, key, name):
    sizes = [int(s) for s in key[0].split("x")]
    # the reference's (B, C, L): every level above the lanes folds into C
    shape = (int(np.prod(sizes[:-1])), sizes[-1])
    return cc.assemble([r["core"][key]["out"][name] for r in ranks], shape)


@pytest.mark.parametrize("key", ALL, ids=_id)
def test_every_check_core_assertion_holds(ranks, key):
    """The reference's check on every rank's outputs, against numpy (the
    ranks made it too, before saving)."""
    n = int(np.prod([int(s) for s in key[0].split("x")]))
    inp = cc.inputs(n)
    for r in ranks:
        cc.check(cc.as_numpy(r["core"][key]["out"]), inp, n, _id(key))
    # the registers are the paper's byte map
    np.testing.assert_array_equal(
        _assembled(ranks, key, "reg").reshape(-1, n),
        inp["x"].reshape(-1, n))


@pytest.mark.parametrize("key", ALL, ids=_id)
def test_every_rank_returns_the_same_bits(ranks, key):
    outs = [cc.as_numpy(r["core"][key]["out"]) for r in ranks]
    for name, val in outs[0].items():
        if name in REGS:
            continue                            # a column a rank
        for o in outs[1:]:
            np.testing.assert_array_equal(o[name], val, err_msg=name)


@pytest.mark.parametrize("grid", GRIDS)
def test_paper_kernels_hold_on_every_rank(ranks, grid):
    """check_core's six programs on the grid's default machine (staged,
    ring, flat; VLEN 64 Kibit), the same bits on every rank."""
    first = ranks[0]["core"][(grid, "programs")]
    assert set(first) == {"fmatmul", "fdotproduct", "jacobi2d", "fconv2d",
                          "softmax", "exp"}
    for r in ranks[1:]:
        for name, val in r["core"][(grid, "programs")].items():
            np.testing.assert_array_equal(val, first[name], err_msg=name)


@pytest.mark.parametrize("key", PAIRS, ids=_id)
def test_registers_equal_the_jax_machine(ranks, jax_runs, key):
    want, _ = jax_runs[key]
    for name in REGS:
        got = _assembled(ranks, key, name)
        np.testing.assert_array_equal(got, want[name].astype(got.dtype),
                                      err_msg=name)


@pytest.mark.parametrize("key", PAIRS, ids=_id)
def test_outputs_equal_the_jax_machine(ranks, jax_runs, key):
    want, _ = jax_runs[key]
    got = cc.as_numpy(ranks[0]["core"][key]["out"])
    n = int(np.prod([int(s) for s in key[0].split("x")]))
    for name in MOVES + ARITH + tuple(f"sd{k}" for k in cc.slide_ks(n)):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the port rounds the product and the sum apart, as the reference's two
    # ops do; XLA's jit contracts them into one FMA (found here on both), so
    # the results differ by at most the product's rounding: one ulp of the
    # product and one of the result (many ulps of a result that cancels)
    inp = cc.inputs(n)
    for name, prod in (("fma", inp["x"] * inp["y"]), ("fmacc", 1.5 * inp["x"])):
        bound = np.spacing(np.abs(prod)) + np.spacing(np.abs(want[name]))
        diff = np.abs(got[name] - want[name])
        print(f"{name}: {int((diff > 0).sum())} of {diff.size} elements differ")
        assert (diff <= bound).all(), (name, float((diff / bound).max()))
    for name in ("sum", "sum2"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-12, err_msg=name)
    assert float(got["isum"]) == float(want["isum"])
    for name in ("max", "max2"):
        assert float(got[name]) == float(want[name])
    assert int(got["cpop"]) == int(want["cpop"])
    np.testing.assert_allclose(got["exp2"], want["exp2"], rtol=1e-14)


@pytest.mark.parametrize("key", PAIRS, ids=_id)
def test_trace_records_equal_the_jax_machine(ranks, jax_runs, key):
    _, want = jax_runs[key]
    got = ranks[0]["core"][key]["trace"]
    assert J.records(got) == J.records(want)


@pytest.mark.parametrize("key", PAIRS, ids=_id)
def test_slide_fill_enters_at_the_padded_end(ranks, jax_runs, key):
    """``vslide1down`` writes its fill at the padded end, not at vl - 1
    (``repro/core/isa.py:83-87``: ``_pad_len`` pads to n² lanes under the
    staged GLSU and to n under the direct one).  At vl = 200 on 8 lanes the
    staged machine's element 199 reads the zero tail, the direct one's the
    fill; the port keeps the reference's behaviour mode for mode."""
    got = cc.as_numpy(ranks[0]["core"][key]["out"])["quirk"]
    want = jax_runs[key][0]["quirk"]
    assert got.shape == (cc.QUIRK_VL,)
    assert got[-1] == (0.0 if key[1] == "staged" else -7.0)
    np.testing.assert_array_equal(got, want)


def test_topology_machines_hold(ranks):
    """check_topology's machines: every (C, L) of 8 under both hierarchies
    and the three (pod, cluster, lane) machines under flat and
    three-level, each keeping the sim's Topology (asserted in the ranks),
    with the same stored bits on every rank."""
    tags = set(ranks[0]["topology"])
    assert {t.split()[0] for t in tags} == {
        "C8xL1", "C4xL2", "C2xL4", "C1xL8", "P2xC2xL2", "P2xC4xL1", "P4xC1xL2"}
    assert len(tags) == 14
    for r in ranks[1:]:
        for tag in tags:
            for name, val in r["topology"][tag]["out"].items():
                np.testing.assert_array_equal(
                    val.numpy(), ranks[0]["topology"][tag]["out"][name].numpy())


def test_readings_count_the_collectives(ranks):
    """Each configuration's readings: host ms an instruction by unit, and
    bytes sent through the mesh's collectives on every rank."""
    for r in ranks:
        st = r["core"][_key("2x4", "staged", "ring", None)]["stats"]
        assert st["bytes"] > 0 and st["collective_ms"] > 0
        assert {"vlsu", "sldu", "redu", "fpu", "masku", "valu"} <= set(st["units"])


@pytest.mark.parametrize("grid", GRIDS)
def test_ring_collectives_hold(ranks, grid):
    """check_collectives on every rank (its assertions made there, against
    numpy): integer sums equal in every variant, the db schedules' gathers
    and scatters bit-equal to seq, every rank the same reduction bits."""
    h = hier_name(len(grid.split("x")))
    for r in ranks:
        out = r["collectives"][grid]
        assert len({out[f"reduce/{v}"]["isum"] for v in ("flat", h, "xla")}) == 1
        for v in ("flat", h):
            np.testing.assert_array_equal(out[f"gather/{v}-db"], out[f"gather/{v}"])
            np.testing.assert_array_equal(out[f"scatter/{v}-db"], out[f"scatter/{v}"])
        for k in out:
            if k.startswith("reduce/"):
                assert out[k] == ranks[0]["collectives"][grid][k], k
