"""The paper's benchmark kernels (Table I), written against the vector ISA.

Each kernel is one function taking a machine (AraXLMachine for execution,
TraceMachine for the cycle model) and numpy-ish operands.  They use exactly
the instruction mix the paper attributes to them:

    fmatmul      unit-stride loads + vfmacc.vf           2*LC  FLOP/cycle peak
    fconv2d      7x7, slide-by-1 + vfmacc.vf             2*LC
    jacobi2d     5-point stencil, slide-by-1 + add/mul   LC
    fdotproduct  vfmul + vfredsum                        LC
    exp          polynomial, basic masks                 28/21 * LC
    softmax      vfredmax + exp + vfredsum + vfdiv       32/25 * LC

Matrices are row-major; a matrix row (length N = n*L*C) is one long vector,
the regime the paper evaluates (Table I problem sizes).  The port's copy of
``repro.core.isa_kernels``, the same instruction mix; a stored register
comes back to the host as numpy through :func:`_host`.
"""
from __future__ import annotations

import numpy as np



def _host(st):
    """A stored register (a tensor on any device) as numpy; None (a trace
    run's store) passes through."""
    return None if st is None else st.detach().cpu().numpy()


def fmatmul(v, A, B):
    """C = A @ B with A (M,K) scalar-side, B (K,N) vector-side.

    The classic long-vector matmul: each C row is accumulated with K
    vfmacc.vf instructions over B's rows, which stay resident in the VRF
    across output rows (LMUL-sized register groups in the paper)."""
    A = np.asarray(A)
    M, K = A.shape
    N = B.shape[1]
    b_regs = [v.vle(B[k]) for k in range(K)]
    out = []
    for i in range(M):
        acc = v.vbrd(0.0, N)
        for k in range(K):
            acc = v.vfmacc_vf(acc, float(A[i, k]), b_regs[k])
        out.append(v.vse(acc))
    if out[0] is None:                      # data-free trace run
        return None
    return np.stack([_host(r) for r in out])


def fdotproduct(v, a, b):
    """sum(a*b): vfmul + the 4-stage reduction."""
    total = 0.0
    for off, vl in v.stripmine(len(a)):
        ra = v.vle(a[off:off + vl])
        rb = v.vle(b[off:off + vl])
        prod = v.vmul(ra, rb)
        total = total + v.vredsum(prod)
    return total


def jacobi2d(v, A):
    """One Jacobi sweep over the interior of each row (1-D 3-point + the
    vertical neighbours): out[i,j] = 0.25*(A[i-1,j]+A[i+1,j]+A[i,j-1]+A[i,j+1]).
    Horizontal neighbours come from slide-by-1 (the RINGI pattern)."""
    A = np.asarray(A)
    R, N = A.shape
    rows = [v.vle(A[i]) for i in range(R)]
    out = []
    for i in range(1, R - 1):
        left = v.vslide1up(rows[i], fill=0.0)    # A[i, j-1]
        right = v.vslide1down(rows[i], fill=0.0)  # A[i, j+1]
        s = v.vadd(rows[i - 1], rows[i + 1])
        s = v.vadd(s, left)
        s = v.vadd(s, right)
        res = v.vmul(s, 0.25)
        st = v.vse(res)
        out.append(_host(st))
    # interior columns only are meaningful (boundary via slide fill=0)
    return np.stack(out) if out[0] is not None else None


def fconv2d(v, A, F):
    """2-D convolution with a small (paper: 7x7) filter, rows as long vectors.

    Column offsets of the filter are realised with repeated slide-by-1 of the
    input row (each slid copy reused across the filter column), row offsets by
    indexing neighbouring input rows; everything else is vfmacc.vf."""
    A = np.asarray(A)
    F = np.asarray(F)
    R, N = A.shape
    fr, fc = F.shape
    out_rows = R - fr + 1
    outs = []
    row_regs = [v.vle(A[i]) for i in range(R)]
    for i in range(out_rows):
        acc = v.vbrd(0.0, N)
        for r in range(fr):
            shifted = row_regs[i + r]
            for c in range(fc):
                if c > 0:
                    shifted = v.vslide1down(shifted, fill=0.0)
                acc = v.vfmacc_vf(acc, float(F[r, c]), shifted)
        st = v.vse(acc)
        outs.append(None if st is None else _host(st)[: N - fc + 1])
    return np.stack(outs) if outs[0] is not None else None


def vexp(v, a):
    """Elementwise exp with the paper's range-reduction polynomial shape:
    a masked clamp (basic mask ops) + polynomial evaluation (the 28-FLOP
    budget is recorded by the machine's vexp)."""
    outs = []
    for off, vl in v.stripmine(len(a)):
        r = v.vle(a[off:off + vl])
        big = v.vmsge(r, 80.0)             # overflow guard (mask op)
        r = v.vmerge(big, v.vbrd(80.0, vl), r)
        e = v.vexp(r)
        st = v.vse(e)
        outs.append(_host(st))
    return np.concatenate(outs) if outs[0] is not None else None


def softmax(v, A):
    """Row-wise softmax: vfredmax -> subtract -> exp -> vfredsum -> vfdiv."""
    A = np.asarray(A)
    outs = []
    for i in range(A.shape[0]):
        r = v.vle(A[i])
        m = v.vredmax(r)
        shifted = v.vsub(r, m)
        e = v.vexp(shifted)
        denom = v.vredsum(e)
        res = v.vdiv(e, denom)
        st = v.vse(res)
        outs.append(_host(st))
    return np.stack(outs) if outs[0] is not None else None


KERNELS = {
    "fmatmul": fmatmul,
    "fconv2d": fconv2d,
    "jacobi2d": jacobi2d,
    "fdotproduct": fdotproduct,
    "exp": vexp,
    "softmax": softmax,
}
