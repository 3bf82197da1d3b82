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
  * attention (flash and paged), f32: both sides form f32 dot products of
    D = 128 terms and f32 softmax sums over up to ~1000 keys in different
    orders, and the exponentials differ by an ulp or two: outputs of order
    0.1-1 move by ~1e-6, so rtol 1e-5, atol 1e-5;
  * attention, bf16: the same f32 math on the same bf16 inputs, rounded
    once to bf16: one ulp, rtol 8e-3, and atol 1e-5 for the f32 part.
A matmul that skips one 16-deep K tile moves a unit-scale output by ~3e-2,
an rmsnorm that mis-scales a row by 1 % moves each element by 1e-2 of its
value, and an attention that drops or adds one key of a few hundred moves a
row by ~1e-3: each fails in either dtype.
"""
from __future__ import annotations

import torch

import numpy as np

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import paged_attention as _pa
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
ATTN_TOL = {torch.bfloat16: (8e-3, 1e-5), torch.float32: (1e-5, 1e-5)}

#: llama3-8b attention: 32 query heads over 8 kv heads of 128
HQ, HKV, HEAD_DIM = 32, 8, 128
#: paged decode at batch 8 over 16-token blocks: lens at and around block
#: edges, an empty sequence and a full 1024-token one
PAGED_LENS = (0, 1, 15, 16, 17, 300, 1023, 640)
PAGED_BT = 16
PAGED_NBLK = 64                          # max_seq 1024 / 16
PAGED_NB = 400                           # pool blocks, block 0 the zero block
#: whole-prompt prefill lengths (causal), and one sliding-window case
FLASH_S = (1, 37, 256, 512)
FLASH_WINDOW = (256, 64)                 # (S, window)


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


def paged_inputs(dtype, device="cuda", seed=0, lens=PAGED_LENS, G=HQ // HKV,
                 D=HEAD_DIM, bt=PAGED_BT, nblk=PAGED_NBLK, nb=PAGED_NB):
    """q (B, Hkv, G, D); the pools as the model holds them, (NB, bt, Hkv, D)
    with block 0 zero, passed as (Hkv, NB, bt, D) views; tables whose rows
    share blocks with each other and point at the zero block inside their
    lengths; lens."""
    B = len(lens)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, HKV, G, D), generator=g, device=device).to(dtype)
    pools = []
    for _ in range(2):
        p = torch.randn((nb, bt, HKV, D), generator=g, device=device).to(dtype)
        p[0] = 0
        pools.append(p.permute(2, 0, 1, 3))
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, nblk), np.int32)
    for b, n in enumerate(lens):
        used = -(-n // bt)
        tables[b, :used] = rng.integers(1, nb, used)
        tables[b, 3:used:7] = 0                  # the zero block, inside the length
    tables[-1, :8] = tables[-2, :8]              # a shared prefix of blocks
    return (q, *pools, torch.from_numpy(tables).to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


def flash_inputs(S, dtype, device="cuda", seed=0, B=1):
    """q, k, v as the model holds them, (B, S, H, D), passed as
    (B, H, S, D) views."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, HEAD_DIM), generator=g, device=device)
               .to(dtype).transpose(1, 2) for h in (HQ, HKV, HKV))
    return q, k, v


def compare(got: torch.Tensor, want: torch.Tensor, tol: tuple) -> dict:
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
    return compare(_mm.matmul(a, b), ref.matmul(a, b), MATMUL_TOL[dtype])


def check_rmsnorm(R, D, dtype, device="cuda") -> dict:
    x, gamma = rmsnorm_inputs(R, D, dtype, device)
    return compare(_rms.rmsnorm(x, gamma, EPS), ref.rmsnorm(x, gamma, EPS),
                    RMSNORM_TOL[dtype])


def check_paged_attention(dtype, device="cuda") -> dict:
    args = paged_inputs(dtype, device)
    return compare(_pa.paged_attention(*args), ref.paged_attention(*args),
                    ATTN_TOL[dtype])


def check_flash_attention(S, dtype, window=None, device="cuda") -> dict:
    q, k, v = flash_inputs(S, dtype, device)
    got = _fa.flash_attention(q, k, v, causal=True, window=window)
    want = ref.attention(q, k, v, causal=True, window=window)
    return compare(got, want, ATTN_TOL[dtype])
