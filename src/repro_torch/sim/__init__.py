"""Cycle-approximate AraXL performance model.

Reproduces the paper's evaluation without RTL: weak-scaling performance
(Fig. 6), interface latency tolerance (Fig. 7) and PPA scaling (Tables
II/III), from instruction traces of the paper's kernels replayed through a
chained-unit pipeline model.

The port's copy of ``repro.sim`` (pure Python): its records are
``repro_torch.core.isa.InstrRecord``, its geometry
``repro_torch.topology.Topology``; every number and formula is the
reference's.
"""
from repro_torch.topology import Topology
from .params import AraXLParams, ara2_params, araxl_params
from .engine import simulate, SimResult
from .kernels import build_trace, KERNEL_BUILDERS
from .trace import TraceMachine

__all__ = ["AraXLParams", "Topology", "ara2_params", "araxl_params",
           "simulate", "SimResult", "build_trace", "KERNEL_BUILDERS",
           "TraceMachine"]
