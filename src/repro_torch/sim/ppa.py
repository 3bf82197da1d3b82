"""Analytical PPA model (paper §IV-D, Tables II/III).

No physical synthesis is possible in this environment, so the area/power
model is fitted to the paper's published 22-nm numbers and used to check the
*scaling* claims (near-perfect 2x area per lane doubling; interfaces <= ~3%
of area; flat ~40 GFLOPs/W energy efficiency).

Fit notes (all least squares on the paper's three configurations):
* cluster area is strictly linear in cluster count (the paper's point);
* GLSU grows slightly super-linearly, area ~ C*(a + b*log2 C) — the extra
  align/shuffle levels of the deeper power-of-2 network;
* RINGI ~ C^0.80, REQI ~ C^1.04 (fitted exponents);
* mm^2 = kGE * 2.014e-7 — the constant reproduces all three area-efficiency
  rows of Table III to <0.3%;
* power ~ (0.017 + 0.0489 * n_lanes) W/GHz reproduces Table III's
  energy-efficiency rows to ~1.5%.
"""
from __future__ import annotations

import math

from .params import AraXLParams

KGE_PER_CLUSTER = 11354.0 / 4.0       # 16L AraXL = 4 clusters (Table II)
KGE_CVA6 = 936.0
MM2_PER_KGE = 2.014e-7 * 1e3          # mm^2 per kGE
W_PER_GHZ_BASE = 0.017
W_PER_GHZ_PER_LANE = 0.0489


def glsu_kge(n_clusters: int) -> float:
    return n_clusters * (63.75 + 4.5 * math.log2(max(2, n_clusters)))


def ringi_kge(n_clusters: int) -> float:
    return 8.23 * n_clusters ** 0.80


def reqi_kge(n_clusters: int) -> float:
    return 8.05 * n_clusters ** 1.04


def area_breakdown_kge(params: AraXLParams) -> dict[str, float]:
    c = params.n_clusters
    parts = {
        "clusters": KGE_PER_CLUSTER * c,
        "cva6": KGE_CVA6,
        "glsu": glsu_kge(c),
        "ringi": ringi_kge(c),
        "reqi": reqi_kge(c),
    }
    parts["total"] = sum(parts.values())
    return parts


def area_mm2(params: AraXLParams) -> float:
    return area_breakdown_kge(params)["total"] * MM2_PER_KGE


def power_w(params: AraXLParams) -> float:
    """Power running fmatmul in the long-vector regime (TT, 0.8 V, 25 C)."""
    return (W_PER_GHZ_BASE + W_PER_GHZ_PER_LANE * params.n_lanes) * params.freq_ghz


def peak_gflops(params: AraXLParams, utilization: float = 1.0) -> float:
    return 2.0 * params.n_lanes * params.freq_ghz * utilization


def energy_eff_gflops_per_w(params: AraXLParams, utilization: float) -> float:
    return peak_gflops(params, utilization) / power_w(params)


def area_eff_gflops_per_mm2(params: AraXLParams, utilization: float) -> float:
    return peak_gflops(params, utilization) / area_mm2(params)


def interface_area_fraction(params: AraXLParams) -> float:
    parts = area_breakdown_kge(params)
    return (parts["glsu"] + parts["ringi"] + parts["reqi"]) / parts["total"]
