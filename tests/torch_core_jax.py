"""The JAX side of the port's machine tests (``tests/test_torch_core_*.py``):
the JAX package's AraXL machine built on an Auto-axis mesh
(``jax.make_mesh(..., axis_types=(AxisType.Auto,) * k)``; the Explicit
axes of ``repro.core.make_machine``'s mesh fail its own
``with_sharding_constraint`` on jax 0.9), and the six programs run on it
and on the port's one-lane CPU machine."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import torch
from jax.sharding import AxisType

from repro.core import isa_kernels as jkernels
from repro.core.isa import AraXLMachine
from repro.core.layout import VectorMachineSpec
from repro.testing.x64 import x64_mode
from repro.topology import parse_topology
from repro_torch.core import make_machine
from repro_torch.testing import check_core as cc


def jax_spec(grid: str, hierarchy: str | None = None) -> VectorMachineSpec:
    """The spec of ``grid`` ("2x4", "2x2x2", ...) at VLEN 4096 on an
    Auto-axis mesh, the topology's hierarchy unless one is given."""
    topo = parse_topology(grid)
    if hierarchy is not None:
        topo = topo.with_hierarchy(hierarchy)
    names = tuple(l.axis for l in topo.levels)
    mesh = jax.make_mesh(topo.shape, names, axis_types=(AxisType.Auto,) * len(names))
    return VectorMachineSpec(mesh, topo.cluster_axis, topo.lane_axis, 4096, 64,
                             topology=topo)


def jax_machine(grid: str, glsu: str = "staged", red: str = "ring",
                hierarchy: str | None = None) -> AraXLMachine:
    """The JAX package's f64 machine of ``grid`` with a trace list."""
    return AraXLMachine(jax_spec(grid, hierarchy), glsu_mode=glsu, reduce_mode=red,
                        dtype=jnp.float64, trace=[])


def records(trace) -> list:
    return [(r.op, r.vl, r.unit, r.flops_per_elem, r.meta) for r in trace]


def program_runs(names) -> tuple:
    """The programs ``names`` at the reference check's sizes on the port's
    one-lane CPU machine and, eagerly, on the JAX (1, 1) machine: (inputs,
    port results, port trace, JAX results, JAX trace)."""
    inp = {k: a for k, a in cc.program_inputs(1).items() if k in names}
    v = make_machine(1, 1, vlen_bits=4096, dtype=torch.float64, trace=[],
                     device="cpu")
    got = cc.run_programs(v, inp)
    with x64_mode(True):
        jm = AraXLMachine(jax_spec("1x1", "flat"), dtype=jnp.float64, trace=[])
        want = cc.run_programs(jm, inp, jkernels)
    return inp, got, v.trace, want, jm.trace
