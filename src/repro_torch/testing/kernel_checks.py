"""Each kernel held against its plain version on the card, at the shapes
the llama3-8b serving path gives it.  Used by ``chip_smoke.py`` and by the
gpu-marked tests.

Each element is held to ``|kernel - plain| <= rtol * |plain| + atol``:
  * bf16 output: both sides form the same products exactly in f32 (a
    product of two bf16 values is exact in f32), sum them in different
    orders and round once to bf16.  Rounding two close f32 values can land
    one bf16 ulp apart, and one ulp is at most 2**-7 of the value, so rtol
    8e-3.  atol bounds the f32 sums' own difference: ~1e-5 on the
    unit-scale matmul outputs these inputs give (atol 1e-3), and ~1e-6 of
    the value for rmsnorm, whose error is relative (atol 1e-6);
  * f32 matmul: the order of up to K = 14336 f32 additions differs, which
    moves a unit-scale output by ~sqrt(K) * 2**-24 * (partial sums of a few
    units), ~2e-5: atol 1e-4, rtol 1e-5;
  * f32 rmsnorm: one D-long sum of squares, an approximate rsqrt and two
    products, ~1e-6 of the value: rtol 1e-5, atol 1e-6.
A matmul that skips one 16-deep K tile moves a unit-scale output by ~3e-2,
and an rmsnorm that mis-scales a row by 1 % moves each element by 1e-2 of
its value: both fail in either dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms

#: (K, N) of the llama3-8b projections
MATMUL_KN = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
             "wg/wi": (4096, 14336), "mlp.wo": (14336, 4096)}
#: M: max_batch 4 at decode, and a ragged prefill length
MATMUL_M = (4, 333)
RMSNORM_R = (1, 4, 333)
D_MODEL = 4096
EPS = 1e-5                               # llama3-8b's norm_eps

#: (rtol, atol) per output dtype
MATMUL_TOL = {torch.bfloat16: (8e-3, 1e-3), torch.float32: (1e-5, 1e-4)}
RMSNORM_TOL = {torch.bfloat16: (8e-3, 1e-6), torch.float32: (1e-5, 1e-6)}


def matmul_inputs(M, K, N, dtype, device="cuda", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((M, K), generator=g, device=device).to(dtype)
    b = (torch.randn((K, N), generator=g, device=device) / K ** 0.5).to(dtype)
    return a, b


def rmsnorm_inputs(R, D, dtype, device="cuda", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (3 * torch.randn((R, D), generator=g, device=device)).to(dtype)
    gamma = torch.randn((D,), generator=g, device=device)    # f32
    return x, gamma


def _compare(got: torch.Tensor, want: torch.Tensor, tol: tuple) -> dict:
    """``limit_use`` is the largest ``|got - want| / (rtol|want| + atol)``
    over the elements (the check passes at <= 1); ``rel_err`` is the largest
    error over the largest ``|want|``, a second reading of the same run."""
    torch.cuda.synchronize()
    rtol, atol = tol
    res = {"max_abs_err": 0.0, "rel_err": 0.0, "limit_use": 0.0,
           "rtol": rtol, "atol": atol}
    same = got.shape == want.shape and got.dtype == want.dtype
    if same and want.numel():
        g, w = got.float(), want.float()
        err = (g - w).abs()
        res["max_abs_err"] = err.max().item()
        res["rel_err"] = res["max_abs_err"] / max(w.abs().max().item(), 1e-30)
        res["limit_use"] = (err / (rtol * w.abs() + atol)).max().item()
    finite = bool(torch.isfinite(got).all())
    res["ok"] = same and finite and res["limit_use"] <= 1.0
    return res


def check_matmul(M, K, N, dtype, device="cuda") -> dict:
    a, b = matmul_inputs(M, K, N, dtype, device)
    return _compare(_mm.matmul(a, b), ref.matmul(a, b), MATMUL_TOL[dtype])


def check_rmsnorm(R, D, dtype, device="cuda") -> dict:
    x, gamma = rmsnorm_inputs(R, D, dtype, device)
    return _compare(_rms.rmsnorm(x, gamma, EPS), ref.rmsnorm(x, gamma, EPS),
                    RMSNORM_TOL[dtype])
