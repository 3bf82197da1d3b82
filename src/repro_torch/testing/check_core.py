"""Distributed check of ``repro_torch.core``: the AraXL machine on a process
mesh, one rank a lane (the port's twin of ``repro.testing.check_core`` and
of the machine part of ``repro.testing.check_topology``).

    PYTHONPATH=src python -m repro_torch.testing.check_core 8 --device cpu
    PYTHONPATH=src python -m repro_torch.testing.check_core 16 --parts flagship --device cpu

spawns the ranks (``testing.subproc.run_ranks``); each runs the parts asked
for and makes every assertion against numpy itself:

``core``      on each grid of ``--grids`` (default (2, 4), (4, 2) and
              (2, 2, 2) at 8 ranks), the reference's five configurations
              (staged and direct GLSU x ring and xla reductions on the flat
              ring, and staged ring on the topology's hierarchy):
              :func:`exercise` (the GLSU round trip and byte map, slides,
              reductions, element-wise ops and masks, an unpadded tail)
              against numpy; then the six paper kernels on the grid's
              default machine at VLEN 64 Kibit.
``topology``  for every power-of-two (C, L) of the ranks, the machine built
              from ``sim.araxl_params(n, lanes_per_cluster=L).topology``
              under both hierarchies (and at 8 ranks the three-level
              (pod, cluster, lane) machines of ``n_pods`` 2 and 4): the
              machine keeps that very Topology, and its round trip,
              reductions and a slide hold.
``collectives`` on each grid, the reference's ``check_collectives``:
              ``reduce_scalar`` (flat, hierarchical, one all-reduce),
              ``ring_allgather`` and ``ring_reduce_scatter`` (every
              variant, seq and db), float and integer payloads.
``flagship``  the (4, 4) machine (AraXL-16), two-level, staged, ring, at
              VLEN 64 Kibit: the GLSU round trip at VLMAX, slides, both
              reductions, fdotproduct on 2**14 elements and softmax on
              (4, 1024).

Each rank saves ``rank<r>.pt`` in the run's directory: every output, its
column of every register, and its readings (host ms an instruction by
unit, ms inside collectives, bytes sent, peak device memory).
``tests/test_torch_core_mesh.py`` also holds the assembled registers and
outputs to the JAX package's machine; ``chip_smoke.py`` (phase 14) runs
the ranks on the card.  Imports only the port.
"""
from __future__ import annotations

import collections
import sys

import numpy as np
import torch

#: the reference's configurations: (glsu_mode, reduce_mode, hierarchy);
#: None is the topology's own hierarchical model at its depth
CONFIGS = (("staged", "ring", "flat"), ("staged", "xla", "flat"),
           ("direct", "ring", "flat"), ("direct", "xla", "flat"),
           ("staged", "ring", None))
#: the slidedown distances of the reference's check (n the lane count)
def slide_ks(n: int) -> tuple:
    return (1, 2, n - 1, n, n + 3, 2 * n)


#: the instructions a unit clock times (``stripmine`` yields, it is not one)
INSTRUCTIONS = ("vle", "vse", "vbrd", "vid", "vadd", "vsub", "vmul", "vdiv",
                "vmax", "vmin", "vfma", "vfmacc_vf", "vexp", "vmslt", "vmsge",
                "vmerge", "vcpop", "vslide1down", "vslide1up", "vslidedown",
                "vredsum", "vredmax")
#: the element count of the slide-fill check (not a multiple of n², so the
#: staged GLSU's padding shows)
QUIRK_VL = 200


def parse_grid(s: str):
    """"2x4" -> the two-level (cluster, lane) Topology; "2x2x2" -> the
    three-level (pod, cluster, lane) one."""
    from repro_torch.topology import parse_topology

    return parse_topology(s)


def inputs(n: int, vl: int | None = None) -> dict:
    """The memory vectors of :func:`exercise` for an n-lane machine: three
    registers of ``vl`` elements (the reference's 3n² by default) and one
    with a ragged tail (2n² + 5)."""
    rng = np.random.default_rng(0)
    vl = vl or n * n * 3
    return {"x": rng.normal(size=vl), "y": rng.normal(size=vl),
            "x2": rng.normal(size=vl * 2 // 3 + 5),
            "xi": rng.integers(-1000, 1000, size=vl).astype(np.float64),
            "xq": rng.normal(size=QUIRK_VL)}


def exercise(v, inp: dict, n: int) -> dict:
    """The reference check's instructions on machine ``v`` (either
    package's: only the ISA surface and a register's ``data`` are used, so
    the JAX machine runs it too, under ``jax.jit``).  Returns the registers'
    data, the stored vectors and the scalars, unconverted."""
    x, y, x2 = inp["x"], inp["y"], inp["x2"]
    out = {}
    r = v.vle(x)
    ry = v.vle(y)
    out["reg"], out["reg_y"] = r.data, ry.data
    out["st"] = v.vse(r)
    out["d1"] = v.vse(v.vslide1down(r, fill=-7.0))
    out["u1"] = v.vse(v.vslide1up(r, fill=-3.0))
    for k in slide_ks(n):
        out[f"sd{k}"] = v.vse(v.vslidedown(r, k))
    out["sum"], out["max"] = v.vredsum(r), v.vredmax(r)
    out["isum"] = v.vredsum(v.vle(inp["xi"]))
    out["fma"] = v.vse(v.vfma(r, ry, ry))
    out["fmacc"] = v.vse(v.vfmacc_vf(ry, 1.5, r))
    for name in ("vadd", "vsub", "vmul", "vdiv", "vmax", "vmin"):
        out[name] = v.vse(getattr(v, name)(r, ry))
    out["addf"] = v.vse(v.vadd(r, 0.25))
    m = v.vmslt(r, 0.0)
    out["mask"] = m.data
    out["cpop"] = v.vcpop(m)
    out["merge"] = v.vse(v.vmerge(m, ry, r))
    out["ge"] = v.vse(v.vmsge(r, 0.5))
    r2 = v.vle(x2)
    vl2 = x2.shape[0]
    out["reg2"] = r2.data
    out["st2"] = v.vse(r2)
    out["sum2"], out["max2"] = v.vredsum(r2), v.vredmax(r2)
    out["exp2"] = v.vse(v.vexp(r2))
    out["brd2"] = v.vbrd(2.5, vl2).data
    out["vid2"] = v.vid(vl2).data
    out["quirk"] = v.vse(v.vslide1down(v.vle(inp["xq"]), fill=-7.0))
    return out


#: exercise()'s outputs that two runs on two devices must give bit for bit:
#: data movement, masks and counts, element-wise arithmetic and the max (the
#: slidedown outputs, ``sd<k>``, too); the sums and ``vexp`` are held within
#: 1e-12 and 1e-14 relative (and the programs' results within 1e-10)
BITWISE = ("reg", "reg_y", "reg2", "mask", "brd2", "vid2", "st", "d1", "u1",
           "merge", "ge", "st2", "quirk", "cpop", "vadd", "vsub", "vmul", "vdiv",
           "vmax", "vmin", "addf", "fma", "fmacc", "isum", "max", "max2")
NEAR = {"sum": 1e-12, "sum2": 1e-12, "exp2": 1e-14,
        # the programs' results, at the reference check's bound
        "fdotproduct": 1e-10, "softmax": 1e-10}


def same(a: dict, b: dict) -> dict:
    """{output: (bit-equal, max relative difference)} of two exercise()
    runs (as numpy)."""
    out = {}
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        rel = float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300),
                           initial=0.0))
        out[k] = (bool(np.array_equal(x, y)), rel)
    return out


def held(a: dict, b: dict) -> list:
    """The outputs where two runs part: a ``BITWISE`` one (or ``sd<k>``) not
    bit-equal, or a ``NEAR`` one past its limit."""
    bad = []
    for k, (eq, rel) in same(a, b).items():
        if (k in BITWISE or k.startswith("sd")) and not eq:
            bad.append(k)
        elif k in NEAR and rel > NEAR[k]:
            bad.append(k)
    return bad


def check(out: dict, inp: dict, n: int, what: str) -> None:
    """The reference check's assertions on :func:`exercise`'s outputs (as
    numpy), against numpy."""
    from numpy.testing import assert_allclose, assert_array_equal

    x, y, x2 = inp["x"], inp["y"], inp["x2"]
    assert_array_equal(out["st"], x, err_msg=what)
    assert_allclose(out["d1"], np.concatenate([x[1:], [-7.0]]), err_msg=what)
    assert_allclose(out["u1"], np.concatenate([[-3.0], x[:-1]]), err_msg=what)
    for k in slide_ks(n):
        assert_allclose(out[f"sd{k}"],
                        np.concatenate([x[k:], np.zeros(k)])[:x.shape[0]],
                        err_msg=f"slidedown k={k} {what}")
    assert_allclose(float(out["sum"]), x.sum(), rtol=1e-12, err_msg=what)
    assert_allclose(float(out["max"]), x.max(), rtol=0, err_msg=what)
    assert float(out["isum"]) == inp["xi"].sum(), what
    assert_allclose(out["fma"], x * y + y, rtol=1e-12, err_msg=what)
    assert int(out["cpop"]) == int((x < 0).sum()), what
    assert_allclose(out["merge"], np.where(x < 0, y, x), err_msg=what)
    assert_array_equal(out["ge"], (x >= 0.5).astype(np.float64), err_msg=what)
    assert_array_equal(out["st2"], x2, err_msg=what)
    assert_allclose(float(out["sum2"]), x2.sum(), rtol=1e-12, err_msg=what)
    assert_allclose(float(out["max2"]), x2.max(), err_msg=what)
    assert_allclose(out["exp2"], np.exp(x2), rtol=1e-12, err_msg=what)
    for name, f in (("vadd", np.add), ("vsub", np.subtract), ("vmul", np.multiply),
                    ("vdiv", np.divide), ("vmax", np.maximum), ("vmin", np.minimum)):
        assert_array_equal(out[name], f(x, y), err_msg=f"{name} {what}")
    assert_array_equal(out["addf"], x + 0.25, err_msg=what)
    assert_array_equal(out["fmacc"], y + 1.5 * x, err_msg=what)
    xq = inp["xq"]
    assert_array_equal(out["quirk"][:-1], xq[1:], err_msg=what)


#: the six programs' operands: "check", the reference check's sizes at
#: rows of n * 8 elements; "card", the Table I shapes of a 64 Kibit
#: register (rows of 1,024 elements; fdotproduct and exp 64 strips)
PROGRAM_SIZES = {
    "check": {"fmatmul": (3, 4), "fconv2d": (5, 3), "jacobi2d": 4,
              "vector": None, "softmax": 3},
    "card": {"fmatmul": (8, 64), "fconv2d": (16, 7), "jacobi2d": 16,
             "vector": 2 ** 16, "softmax": 8},
}


def program_inputs(n: int, size: str = "check") -> dict:
    """{program: its operands after the machine}, from a fixed seed."""
    sz = PROGRAM_SIZES[size]
    N = n * 8 if size == "check" else 1024
    rng = np.random.default_rng(1)
    M, K = sz["fmatmul"]
    A, B = rng.normal(size=(M, K)), rng.normal(size=(K, N))
    nv = sz["vector"] or N
    a, b = rng.normal(size=nv), rng.normal(size=nv)
    rows = rng.normal(size=(sz["jacobi2d"], N))
    R, f = sz["fconv2d"]
    F, Img = rng.normal(size=(f, f)), rng.normal(size=(R, N))
    S = rng.normal(size=(sz["softmax"], N))
    return {"fmatmul": (A, B), "fdotproduct": (a, b), "jacobi2d": (rows,),
            "fconv2d": (Img, F), "softmax": (S,), "exp": (a,)}


def program_oracles(inp: dict) -> dict:
    """numpy's results of :func:`program_inputs`' programs."""
    from numpy.lib.stride_tricks import sliding_window_view

    A, B = inp["fmatmul"]
    a, b = inp["fdotproduct"]
    (M,) = inp["jacobi2d"]
    pad = np.pad(M, ((0, 0), (1, 1)))
    Img, F = inp["fconv2d"]
    (S,) = inp["softmax"]
    e = np.exp(S - S.max(axis=1, keepdims=True))
    return {"fmatmul": A @ B, "fdotproduct": float(a @ b),
            "jacobi2d": 0.25 * (M[:-2] + M[2:] + pad[1:-1, :-2] + pad[1:-1, 2:]),
            "fconv2d": np.einsum("ijkl,kl->ij", sliding_window_view(Img, F.shape), F),
            "softmax": e / e.sum(axis=1, keepdims=True), "exp": np.exp(inp["exp"][0])}


def run_programs(v, inp: dict, kernels=None) -> dict:
    """Each program of ``kernels`` (default the port's ``isa_kernels``) on
    machine ``v``; fdotproduct's total as a float."""
    if kernels is None:
        from repro_torch.core import isa_kernels as kernels

    out = {name: kernels.KERNELS[name](v, *args) for name, args in inp.items()}
    if "fdotproduct" in out:
        out["fdotproduct"] = float(out["fdotproduct"])
    return out


def programs_check(v, n: int) -> dict:
    """The six paper kernels on ``v`` at the reference check's sizes,
    against numpy within its 1e-10 relative; returns their outputs."""
    from numpy.testing import assert_allclose

    inp = program_inputs(n)
    out = run_programs(v, inp)
    for name, want in program_oracles(inp).items():
        assert_allclose(out[name], want, rtol=1e-10, err_msg=name)
    return out


class UnitClock:
    """The machine ``v`` (with a ``trace`` list) whose instructions each add
    their host ms to their unit (the unit of the record the call appended),
    the card synchronised before and after; everything else passes
    through, so the ISA programs run on it unchanged."""

    def __init__(self, v):
        self.v = v
        self.ms = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._sync = (torch.cuda.synchronize if v.device.type == "cuda"
                      else lambda: None)

    def __getattr__(self, name):
        attr = getattr(self.v, name)
        if name not in INSTRUCTIONS:
            return attr

        def timed(*args, **kw):
            from repro_torch.testing.timing import now

            self._sync()
            k, t0 = len(self.v.trace), now()
            res = attr(*args, **kw)
            self._sync()
            unit = self.v.trace[-1].unit if len(self.v.trace) > k else name
            self.ms[unit] += 1e3 * (now() - t0)
            self.calls[unit] += 1
            return res
        return timed

    def per_unit(self) -> dict:
        """{unit: (calls, host ms a call)}."""
        return {u: (self.calls[u], self.ms[u] / self.calls[u]) for u in self.calls}


def to_host(out):
    """Tensors (and nested dicts of them) as CPU tensors, others as they are."""
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    return out.detach().cpu() if torch.is_tensor(out) else out


def as_numpy(out: dict) -> dict:
    return {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in out.items()}


def _machine(world, topology, **kw):
    from repro_torch.core import make_machine

    return make_machine(topology=topology, dtype=torch.float64, trace=[],
                        world=world, **kw)


def measured(v, fn):
    """``fn(clocked v)``'s result and its readings: the unit clock's host ms
    an instruction, and ``testing.subproc.readings`` of the machine's mesh."""
    from repro_torch.testing.subproc import readings

    clock = UnitClock(v)
    with readings(v.spec.mesh, v.device) as st:
        res = fn(clock)
    return res, {**st, "units": clock.per_unit()}


def part_core(world, grids, vlen_bits: int) -> dict:
    from repro_torch.topology import hier_name

    res = {}
    for g in grids:
        topo = parse_grid(g)
        n = topo.n_lanes
        inp = inputs(n)
        for glsu_mode, reduce_mode, hierarchy in CONFIGS:
            h = hierarchy or hier_name(topo.n_levels)
            v = _machine(world, topo, vlen_bits=vlen_bits, glsu_mode=glsu_mode,
                         reduce_mode=reduce_mode, hierarchy=h)
            out, st = measured(v, lambda c: to_host(exercise(c, inp, n)))
            check(as_numpy(out), inp, n, f"{g} {glsu_mode}/{reduce_mode}/{h}")
            res[(g, glsu_mode, reduce_mode, h)] = {"out": out, "stats": st,
                                                   "trace": list(v.trace)}
        v = _machine(world, topo.with_hierarchy("flat"), vlen_bits=65536)
        res[(g, "programs")], st = measured(v, lambda c: programs_check(c, n))
        res[(g, "programs_stats")] = st
        if world.rank == 0:
            print(f"check_core {g} OK (n={n}, vlen_bits={vlen_bits})", flush=True)
    return res


def part_topology(world) -> dict:
    """check_topology's machine assertions on the world's ranks."""
    from numpy.testing import assert_allclose, assert_array_equal

    from repro_torch.sim import araxl_params
    from repro_torch.topology import HIERARCHIES, factorizations

    n = world.size
    grids = factorizations(n)
    assert grids, f"n={n} has no power-of-two (C, L) factorisation to check"
    rng = np.random.default_rng(0)
    res = {}

    def run(v, tag):
        x = rng.normal(size=n * n * 2)

        def prog(c):
            r = c.vle(x)
            return to_host({"st": c.vse(r), "sum": c.vredsum(r), "max": c.vredmax(r),
                            "d1": c.vse(c.vslide1down(r, fill=-1.0))})
        out, st = measured(v, prog)
        assert_array_equal(out["st"].numpy(), x, err_msg=tag)
        assert_allclose(float(out["sum"]), x.sum(), rtol=1e-12, err_msg=tag)
        assert_allclose(float(out["max"]), x.max(), rtol=0, err_msg=tag)
        assert_allclose(out["d1"].numpy(), np.concatenate([x[1:], [-1.0]]),
                        err_msg=tag)
        res[tag] = {"out": out, "stats": st}

    for C, L in grids:
        params = araxl_params(n, lanes_per_cluster=L)
        assert params.topology.grid == (C, L)
        for hierarchy in HIERARCHIES:
            topo = params.with_hierarchy(hierarchy).topology
            v = _machine(world, topo, vlen_bits=4096)
            assert v.spec.topology == topo, (v.spec.topology, topo)
            assert v.hierarchy == hierarchy
            run(v, f"C{C}xL{L} {hierarchy}")
    if n == 8:
        for n_pods, lpc in ((2, 2), (2, 1), (4, 2)):
            params = araxl_params(n, lanes_per_cluster=lpc, n_pods=n_pods)
            topo = params.topology
            assert topo.n_levels == 3
            assert topo.shape == (n_pods, n // n_pods // lpc, lpc)
            for hierarchy in ("flat", "three-level"):
                topo_h = params.with_hierarchy(hierarchy).topology
                v = _machine(world, topo_h, vlen_bits=4096)
                assert v.spec.topology == topo_h
                assert v.hierarchy == hierarchy
                assert set(v.spec.mesh.shape) == {"pod", "cluster", "lane"}
                run(v, f"P{n_pods}xC{n // n_pods // lpc}xL{lpc} {hierarchy}")
    if world.rank == 0:
        print(f"check_topology OK (n={n}, grids={grids})", flush=True)
    return res


def part_collectives(world, grids) -> dict:
    """The reference's ``check_collectives`` assertions (without its
    timings) on each grid: ``reduce_scalar`` sum, max and min on the flat
    ring, the topology's hierarchy and one all-reduce (integer sums the
    same in all three); ``ring_allgather`` and ``ring_reduce_scatter`` in
    every variant, seq and db, with a consumer on the db all-gather; each
    against numpy (float sums within 1e-12, integer ones bit for bit)."""
    from numpy.testing import assert_allclose, assert_array_equal

    from repro_torch.core import make_topology_mesh, ring
    from repro_torch.core.layout import VectorMachineSpec
    from repro_torch.topology import hier_name

    res = {}
    for g in grids:
        topo = parse_grid(g)
        n, h = topo.n_lanes, hier_name(topo.n_levels)
        mesh = make_topology_mesh(topo, world)
        spec = VectorMachineSpec(mesh, topo.cluster_axis, topo.lane_axis,
                                 topology=topo)
        p, dev = spec.ring_pos, world.device
        rng = np.random.default_rng(0)
        B, m = 4 * n, 3
        xf = rng.normal(size=(B, n))
        xi = rng.integers(-1_000, 1_000, size=(B, n))
        shard = rng.normal(size=(n, 6))
        cf = rng.normal(size=(n, n * m))
        ci = rng.integers(-1_000, 1_000, size=(n, n * m))
        col = lambda a: torch.as_tensor(np.ascontiguousarray(a[:, p]), device=dev)
        row = lambda a: torch.as_tensor(np.ascontiguousarray(a[p]), device=dev)
        variants = {"flat": dict(mode="ring", hierarchy="flat"),
                    h: dict(mode="ring", hierarchy=h), "xla": dict(mode="xla")}
        db = {"flat-db": dict(mode="ring", hierarchy="flat", schedule="db"),
              f"{h}-db": dict(mode="ring", hierarchy=h, schedule="db")}
        out = {}
        for name, kw in variants.items():
            got = {op: float(ring.reduce_scalar(spec, col(xf), op, **kw))
                   for op in ("sum", "max", "min")}
            assert_allclose(got["sum"], xf.sum(), rtol=1e-12, err_msg=name)
            assert got["max"] == xf.max() and got["min"] == xf.min(), name
            got["isum"] = int(ring.reduce_scalar(spec, col(xi), "sum", **kw))
            assert got["isum"] == int(xi.sum()), name
            out[f"reduce/{name}"] = got
        want_ag = shard.reshape(-1)
        for name, kw in {**variants, **db}.items():
            got = ring.ring_allgather(spec, row(shard), **kw).cpu().numpy()
            assert_array_equal(got, want_ag, err_msg=f"ring_allgather/{name}")
            rs = ring.ring_reduce_scatter(spec, row(cf), **kw).cpu().numpy()
            assert_allclose(rs, cf.sum(axis=0).reshape(n, m)[p], rtol=1e-12,
                            err_msg=f"ring_reduce_scatter/{name}")
            rsi = ring.ring_reduce_scatter(spec, row(ci), **kw).cpu().numpy()
            assert_array_equal(rsi, ci.sum(axis=0).reshape(n, m)[p],
                               err_msg=f"ring_reduce_scatter/int/{name}")
            out[f"gather/{name}"], out[f"scatter/{name}"] = got, rs
        got = ring.ring_allgather_local_db(row(shard), spec.ring_axes, n, mesh,
                                           consume=lambda b, j: 2.0 * b + 1.0)
        assert_array_equal(got.cpu().numpy(), 2.0 * want_ag + 1.0,
                           err_msg="ring_allgather_db/consume")
        res[g] = out
        if world.rank == 0:
            print(f"check_collectives {g} OK (n={n})", flush=True)
    return res


#: the flagship part's sizes: fdotproduct's elements, softmax's rows
FLAGSHIP_DOT = 2 ** 14
FLAGSHIP_SOFTMAX_ROWS = 4


def flagship_inputs(vlmax: int) -> tuple:
    """The flagship part's operands: a register of VLMAX elements,
    fdotproduct's two vectors and softmax's rows."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=vlmax)
    ab = (rng.normal(size=FLAGSHIP_DOT), rng.normal(size=FLAGSHIP_DOT))
    return x, ab, (rng.normal(size=(FLAGSHIP_SOFTMAX_ROWS, vlmax)),)


def part_flagship(world) -> dict:
    """AraXL-16 ((4, 4), two-level, staged, ring) at VLEN 64 Kibit."""
    from numpy.testing import assert_allclose, assert_array_equal

    from repro_torch.core import isa_kernels
    from repro_torch.topology import Topology

    topo = Topology(4, 4, hierarchy="two-level")
    v = _machine(world, topo, vlen_bits=65536)
    x, (a, b), (S,) = flagship_inputs(v.vlmax)

    def run(c):
        r = c.vle(x)
        out = {"reg": r.data, "st": c.vse(r),
               "d1": c.vse(c.vslide1down(r, fill=-7.0)),
               "u1": c.vse(c.vslide1up(r, fill=-3.0)),
               "sum": c.vredsum(r), "max": c.vredmax(r)}
        out = to_host(out)
        out["fdotproduct"] = float(isa_kernels.fdotproduct(c, a, b))
        out["softmax"] = isa_kernels.softmax(c, S)
        return out

    out, st = measured(v, run)
    o = as_numpy(out)
    assert_array_equal(o["st"], x)
    assert_array_equal(o["d1"], np.concatenate([x[1:], [-7.0]]))
    assert_array_equal(o["u1"], np.concatenate([[-3.0], x[:-1]]))
    assert_allclose(float(o["sum"]), x.sum(), rtol=1e-12)
    assert float(o["max"]) == x.max()
    assert_allclose(o["fdotproduct"], float(a @ b), rtol=1e-10)
    e = np.exp(S - S.max(axis=1, keepdims=True))
    assert_allclose(o["softmax"], e / e.sum(axis=1, keepdims=True), rtol=1e-10)
    if world.rank == 0:
        print(f"check_core flagship OK (4 x 4, VLMAX {v.vlmax})", flush=True)
    return {"flagship": {"out": out, "stats": st, "trace": list(v.trace)}}


PARTS = {"core": lambda world, args: part_core(world, args.grids.split(","),
                                               args.vlen_bits),
         "topology": lambda world, args: part_topology(world),
         "collectives": lambda world, args: part_collectives(
             world, args.grids.split(",")),
         "flagship": lambda world, args: part_flagship(world)}


def rank_main(args) -> None:
    from repro_torch.testing.subproc import join

    with join(args) as world:
        res = {"device": str(world.device)}
        for part in args.parts.split(","):
            res[part] = PARTS[part](world, args)
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def load(d, world: int) -> list:
    """Every rank's saved results, in rank order."""
    return [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]


def assemble(cols: list, shape: tuple) -> np.ndarray:
    """The ranks' (B,) columns (rank order = ring order on these meshes) as
    the reference's (B, *shape) global register."""
    return torch.stack(cols, dim=1).numpy().reshape((-1,) + tuple(shape))


def main(argv=None) -> list:
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("the AraXL machine on a process mesh against numpy")
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--parts", default="core,topology,collectives")
    ap.add_argument("--grids", default="2x4,4x2,2x2x2")
    ap.add_argument("--vlen-bits", type=int, default=4096)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return []
    require_device(args.device)
    extra = ["--parts", args.parts, "--grids", args.grids,
             "--vlen-bits", str(args.vlen_bits)]
    d = run_ranks("repro_torch.testing.check_core", args.n, str(args.n), *extra,
                  device=args.device, workdir=args.dir)
    ranks = load(d, args.n)
    print(f"check_core OK ({args.n} ranks on {args.device}: {args.parts})")
    return ranks


if __name__ == "__main__":
    main(sys.argv[1:])
