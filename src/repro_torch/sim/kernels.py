"""Instruction-trace builders for the paper's benchmark kernels (Table I).

Each builder mirrors the structure of the Ara/AraXL assembly kernels (register
blocking, sliding input windows, stripmining) and emits the trace through a
:class:`TraceMachine`.  Problem sizes follow Table I: a matrix row is one long
vector of ``N = n_lanes * bytes_per_lane / 8`` DP elements (weak scaling keeps
bytes/lane constant as lanes grow).
"""
from __future__ import annotations

from typing import Callable

from .params import AraXLParams
from .trace import TraceMachine


def _vl(params: AraXLParams, bytes_per_lane: int) -> int:
    return params.n_lanes * bytes_per_lane // (params.sew_bits // 8)


def fmatmul_trace(v: TraceMachine, params: AraXLParams, bytes_per_lane: int,
                  M: int = 64, K: int = 256, rows_blk: int = 8) -> None:
    """C[M,N] = A[M,K] @ B[K,N]; B rows streamed, ``rows_blk`` accumulators
    resident (the paper's LMUL register grouping)."""
    N = _vl(params, bytes_per_lane)
    for i0 in range(0, M, rows_blk):
        accs = [v.vbrd(0.0, N) for _ in range(rows_blk)]
        for k in range(K):
            b = v.vle(vl=N)
            for r in range(rows_blk):
                v.scalar_load()                     # A[i0+r, k] through d-cache
                accs[r] = v.vfmacc_vf(accs[r], 0.0, b)
        for r in range(rows_blk):
            v.vse(accs[r])


def fconv2d_trace(v: TraceMachine, params: AraXLParams, bytes_per_lane: int,
                  rows: int = 256, fr: int = 7, fc: int = 7) -> None:
    """7x7 convolution, rows as long vectors; a sliding window of ``fr`` input
    rows stays VRF-resident, each output row loads one new input row; column
    taps via chained slide-by-1 (RINGI traffic)."""
    N = _vl(params, bytes_per_lane)
    for r in range(fr):                              # prologue: fill the window
        v.vle(vl=N)
    for i in range(rows - fr + 1):
        if i > 0:
            v.vle(vl=N)                              # one new row
        acc = v.vbrd(0.0, N)
        for r in range(fr):
            shifted = None
            for c in range(fc):
                if c == 0:
                    shifted = v._rec("vmv.v.v", N, "valu")
                else:
                    shifted = v.vslide1down(shifted)
                v.scalar_load()                      # filter coefficient
                acc = v.vfmacc_vf(acc, 0.0, shifted)
        v.vse(acc)


def jacobi2d_trace(v: TraceMachine, params: AraXLParams, bytes_per_lane: int,
                   rows: int = 256) -> None:
    """5-point stencil; 3-row sliding window; horizontal taps by slide-by-1."""
    N = _vl(params, bytes_per_lane)
    top = v.vle(vl=N)
    mid = v.vle(vl=N)
    for i in range(1, rows - 1):
        bot = v.vle(vl=N)
        left = v.vslide1up(mid)
        right = v.vslide1down(mid)
        s = v.vadd(top, bot)
        s = v.vadd(s, left)
        s = v.vadd(s, right)
        res = v.vmul(s, None)
        v.vse(res)
        top, mid = mid, bot


def fdotproduct_trace(v: TraceMachine, params: AraXLParams, bytes_per_lane: int,
                      ) -> None:
    """dot(a, b) with LMUL=8 strips and the 4-stage reduction per strip."""
    total = _vl(params, bytes_per_lane)
    for off, vl in v.stripmine(total, lmul=8):
        a = v.vle(vl=vl)
        b = v.vle(vl=vl)
        p = v.vmul(a, b)
        v.vredsum(p)
        v.scalar_op()                                # accumulate partial


def exp_trace(v: TraceMachine, params: AraXLParams, bytes_per_lane: int) -> None:
    """Elementwise exp: range-reduction masks + polynomial (28 FLOP/elem)."""
    total = _vl(params, bytes_per_lane)
    for off, vl in v.stripmine(total, lmul=1):
        a = v.vle(vl=vl)
        m = v.vmsge(a, None)
        a = v.vmerge(m, a, None)
        e = v.vexp(a)
        v.vse(e)


def softmax_trace(v: TraceMachine, params: AraXLParams, bytes_per_lane: int,
                  rows: int = 64) -> None:
    N = _vl(params, bytes_per_lane)
    for i in range(rows):
        r = v.vle(vl=N)
        m = v.vredmax(r)
        s = v.vsub(r, m)
        e = v.vexp(s)
        d = v.vredsum(e)
        v.vdiv(e, d)
        v.vse(e)


KERNEL_BUILDERS: dict[str, Callable] = {
    "fmatmul": fmatmul_trace,
    "fconv2d": fconv2d_trace,
    "jacobi2d": jacobi2d_trace,
    "fdotproduct": fdotproduct_trace,
    "exp": exp_trace,
    "softmax": softmax_trace,
}

#: peak DP-FLOP/cycle per (lane count) for each kernel — Table I "Max Perf".
def max_perf_flop_per_cycle(kernel: str, n_lanes: int) -> float:
    return {
        "fmatmul": 2.0 * n_lanes,
        "fconv2d": 2.0 * n_lanes,
        "jacobi2d": 1.0 * n_lanes,
        "fdotproduct": 1.0 * n_lanes,
        "exp": 28.0 / 21.0 * n_lanes,
        "softmax": 32.0 / 25.0 * n_lanes,
    }[kernel]


def build_trace(kernel: str, params: AraXLParams, bytes_per_lane: int,
                **kw) -> list:
    # The trace machine carries the shared Topology so slides are tagged with
    # the wire level (intra/inter-cluster) their critical path crosses.
    v = TraceMachine(params.vlen_bits, params.sew_bits,
                     topology=params.topology)
    KERNEL_BUILDERS[kernel](v, params, bytes_per_lane, **kw)
    return v.trace
