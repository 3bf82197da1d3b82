"""Each kernel held against its plain version on the card, at the shapes
the llama3-8b serving path gives it.  Used by ``chip_smoke.py`` and by the
gpu-marked tests.

Each element is held to ``|kernel - plain| <= rtol * |plain| + atol``:
  * bf16 output: both sides form the same products exactly in f32 (a
    product of two bf16 values is exact in f32), sum them in different
    orders and round once to bf16.  Rounding two close f32 values can land
    one bf16 ulp apart, and one ulp is at most 2**-7 of the value, so rtol
    8e-3.  atol bounds the f32 sums' own difference: ~1e-5 on the
    unit-scale matmul outputs these inputs give (atol 1e-3; the bf16
    matmul kernels add on the tensor cores, 16 products a step in the
    unit's own order and rounding, and split-K adds the slices' partials
    after them: other orders of the same f32 sums), and ~1e-6 of
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

The paper's Table I kernels, at the shapes of two configurations
(``TABLE1``) and at ragged ones:
  * jacobi2d: kernel and plain version do the same f32 operations in the
    same order and round once, so they are held to equality (0, 0), in
    both dtypes;
  * expv: the same f32 operations, each rounded once (the plain version
    emulates every fused multiply-add in f64), so at most one ulp of the
    output dtype apart, and 0 is expected; inputs span +-100 to reach the
    clip.  ``sweep_expv`` holds the kernel to the same rule on every f32
    and bf16 bit pattern (a NaN where the plain version gives one) and on
    ``expv_edge_inputs``, the inputs where k = round(x / ln2) turns;
  * fconv2d: each side sums fr*fc taps in one order, the kernel by fused
    multiply-adds, the plain version by a product and an add, so each is
    within (fr*fc + 1) * 2**-24 * sum|f x| of the exact sum and the two
    within twice that, element by element (``conv_bound``); bf16 adds one
    bf16 ulp, rtol 8e-3;
  * dotprod and dotprod_hier: held against the f64 sum of the products
    within a 6-sigma bound on the f32 rounding (``dot_bound``): each
    addition s = x + y rounds by a random fraction of 2**-24 |s|, so the
    error's variance is at most 2**-48 times the sum of s**2 over every
    addition behind the result.  Along a thread's chain of c additions of
    products p (mean mu, variance v) the partial sums' squares add to
    c**2 v / 2 + c**3 mu**2 / 3.  Over the n / c chains, and the trees
    above them (``reduction.dot_chain`` counts their levels into c; a
    level of sums of k products adds n k mu**2, and k doubles up to n),
    that is at most c * sum(p**2) + (c**2 / n + 2) * sum(p)**2.  The
    worst case (Higham's c * 2**-24 * sum|p|) is ~1e4 at 2**28 elements,
    the size of the result itself; this bound is ~0.2 there.  A second call must give
    the same bits; on inputs in {-1, 0, 1} every partial sum is an integer
    far below 2**24, so the result must equal the exact sum; and two dots
    that compute in bf16 (``dot_controls``: products rounded to bf16, and
    inputs rounded to bf16) must each read above the limit;
  * softmax_rows, f32: both sides' exponentials are within 2 ulp of e^x and
    their row sums add the same terms in different orders (chains of up to
    ~2,000 terms, so ~2e-6 of the sum by a random walk): rtol 2e-5; bf16
    one ulp more, rtol 8e-3; atol 1e-30 only so that an exact 0 divides.
    Masked inputs (-inf at the head of each row and at every eighth
    element) reach both branches' handling of -inf: those elements are 0;
A jacobi2d that drops a neighbour, an exp off by 2 ulp, a dot that loses
one product or rounds to bf16, or a softmax row normalised to 1 +- 1e-4
fails.
"""
from __future__ import annotations

import math

import torch

import numpy as np

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import reduction as _red
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import stencil as _st

#: (K, N) of the llama3-8b projections
MATMUL_KN = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
             "wg/wi": (4096, 14336), "mlp.wo": (14336, 4096)}
#: M on the main paths: decode batches (1, 4 dense, 8 paged), a 128-token
#: prefill chunk, and whole prompts (333 ragged, 512)
MATMUL_M = (1, 4, 8, 128, 333, 512)
#: ragged (M, K, N, dtype): each bf16 kernel's M, N and K edges (K = 4104
#: leaves an 8-deep last K step, N = 1032 and 4104 an 8-wide last column
#: tile), tiny K and N, bf16 shapes whose rows are not 16-byte aligned
#: (the simt kernel), and the f32 edges
MATMUL_RAGGED = (
    [(m, 4104, n, torch.bfloat16) for m in (5, 9, 65, 130) for n in (1032, 4104)]
    + [(1, 8, 8, torch.bfloat16), (16, 8, 8, torch.bfloat16),
       (5, 130, 33, torch.bfloat16), (9, 130, 33, torch.bfloat16),
       (12, 4100, 1030, torch.bfloat16)]
    + [(m, k, n, torch.float32) for m, k, n in
       ((1, 1, 1), (8, 130, 33), (9, 130, 33), (17, 33, 65), (3, 0, 5))])
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
#: whole-prompt prefill lengths (causal): the dense path's 35-223 and the
#: paged path's 71-445 tokens, ragged against the 64-row and 64-key tiles
FLASH_S = (1, 37, 223, 256, 333, 445, 512)
#: (B, S, window): those, two sequences, and sliding windows that end on a
#: tile edge (64) and inside tiles (100, 37)
FLASH_CASES = tuple((1, S, None) for S in FLASH_S) + (
    (2, 223, None), (1, 256, 64), (1, 333, 100), (1, 445, 37))


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
    if got.is_cuda:
        torch.cuda.synchronize()
    rtol, atol = tol                    # atol a number, or a bound per element
    res = {"max_abs_err": 0.0, "rel_err": 0.0, "limit_use": 0.0, "rtol": rtol,
           "atol": float(atol.max()) if torch.is_tensor(atol) and atol.numel()
           else float(atol)}
    same = got.shape == want.shape and got.dtype == want.dtype
    if same and want.numel():
        g, w = got.float(), want.float()
        err = (g - w).abs()
        res["max_abs_err"] = err.max().item()
        res["rel_err"] = res["max_abs_err"] / max(w.abs().max().item(), 1e-30)
        limit = rtol * w.abs() + atol
        res["limit_use"] = torch.where(err == 0, 0.0, err / limit).max().item()
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


def check_flash_attention(S, dtype, window=None, device="cuda", B=1) -> dict:
    """The llama3-8b heads, causal; ``variant`` names the kernel taken."""
    q, k, v = flash_inputs(S, dtype, device, B=B)
    got = _fa.flash_attention(q, k, v, causal=True, window=window)
    want = ref.attention(q, k, v, causal=True, window=window)
    res = compare(got, want, ATTN_TOL[dtype])
    res["variant"] = _fa.variant(S, S, HEAD_DIM, dtype)
    return res


def check_flash_head_dim(D, causal, dtype, device="cuda") -> dict:
    """Two sequences of 70 over 4 q and 2 kv heads of D, window 9 (a masked
    edge in every tile), as (B, S, H, D) views."""
    g = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn((2, 70, h, D), generator=g, device=device)
               .to(dtype).transpose(1, 2) for h in (4, 2, 2))
    got = _fa.flash_attention(q, k, v, causal=causal, window=9)
    want = ref.attention(q, k, v, causal=causal, window=9)
    res = compare(got, want, ATTN_TOL[dtype])
    res["variant"] = _fa.variant(70, 70, D, dtype)
    return res


# -- the paper's Table I kernels ------------------------------------------------

#: two configurations, both f32 on the card (bf16 too in the element checks):
#: "table1-paper" is the paper's problem size, vectors of 4096 elements (the
#: 64-lane AraXL at 512 bytes a lane: 64 * 512 / 8) and the trace builders'
#: row counts, the C x L = 16 x 4 machine; "table1-card" streams about 1 GiB
#: an operand from HBM.  Keys: jacobi (H, W); conv (H, W) of the input and
#: the filter side; dot n; softmax (R, W), each row resident, and "wide"
#: rows past the resident limit; hier (C, L) machines, each under both
#: hierarchies.
TABLE1 = {
    "table1-paper": {"jacobi": (256, 4096), "conv": (256, 4096, 7),
                     "dot": 4096, "softmax": [(64, 4096)],
                     "hier": [(16, 4)]},
    "table1-card": {"jacobi": (16384, 16384), "conv": (8198, 8198, 7),
                    "dot": 2 ** 28, "softmax": [(32768, 8192), (256, 2 ** 20)],
                    "hier": [(16, 4), (8, 8)]},
}
HIERARCHIES = ("two-level", "flat")
#: ragged shapes: tile and vector edges, a row past the resident limit;
#: "softmax_masked" takes masked rows (``softmax_inputs(masked=True)``)
RAGGED = {"jacobi": [(333, 1001)], "conv": [(72, 519, 3), (76, 523, 7)],
          "dot": [4099], "expv": [4099], "softmax": [(7, 1000), (3, 300001)],
          "softmax_masked": [(7, 1000), (3, 300001)]}
JACOBI_TOL = (0.0, 0.0)
SOFTMAX_TOL = {torch.bfloat16: (8e-3, 1e-30), torch.float32: (2e-5, 1e-30)}
U32 = 2.0 ** -24                        # f32 unit roundoff


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def grid_inputs(H, W, dtype, device="cuda", seed=0):
    return torch.randn((H, W), generator=_gen(device, seed), device=device).to(dtype)


def conv_inputs(H, W, f, dtype, device="cuda", seed=0):
    """x (H, W) and an f32 (f, f) filter."""
    g = _gen(device, seed)
    x = torch.randn((H, W), generator=g, device=device).to(dtype)
    return x, torch.randn((f, f), generator=g, device=device)


def vec_inputs(n, dtype, device="cuda", seed=0):
    g = _gen(device, seed)
    return tuple(torch.randn(n, generator=g, device=device).to(dtype)
                 for _ in range(2))


def sign_inputs(n, dtype, device="cuda", seed=0):
    """Two vectors of values in {-1, 0, 1}."""
    g = _gen(device, seed)
    return tuple(torch.randint(-1, 2, (n,), generator=g, device=device).to(dtype)
                 for _ in range(2))


def exp_inputs(n, dtype, device="cuda", seed=0):
    """Uniform in [-100, 100]: past the clip at +-80 on both sides."""
    u = torch.rand(n, generator=_gen(device, seed), device=device)
    return (200 * u - 100).to(dtype)


def softmax_inputs(R, W, dtype, device="cuda", seed=0, masked=False):
    """4 * randn; ``masked``: -inf in each row's first min(2048, W // 2)
    elements (the first two of every thread of the two-read branch's 1024)
    and at every eighth element."""
    x = 4 * torch.randn((R, W), generator=_gen(device, seed), device=device)
    if masked:
        x[:, :min(2048, W // 2)] = -math.inf
        x[:, ::8] = -math.inf
    return x.to(dtype)


def conv_bound(x, filt):
    """Per output element, twice the larger of the two sides' error bounds:
    (fr*fc + 1) * 2**-24 * sum of |f x| over the taps."""
    fr, fc = filt.shape
    return 2 * (fr * fc + 1) * U32 * ref.fconv2d(x.float().abs(), filt.abs())


def dot_bound(a, b, chain):
    """Six standard deviations of an f32 sum's rounding error, for a sum
    whose additions form chains of at most ``chain``: 6 * 2**-24 *
    sqrt(chain * sum(p**2) + (chain**2 / n + 2) * sum(p)**2), p = a*b (see
    the module's note)."""
    p = a.double() * b.double()
    s2 = (p * p).sum().item()
    mean_sq = p.sum().item() ** 2
    return 6 * U32 * math.sqrt(chain * s2
                               + (chain ** 2 / max(p.numel(), 1) + 2) * mean_sq)


def ulps(got, want) -> float:
    """The largest distance in ulps of the dtype between two tensors of
    positive (or equal) values."""
    itype = torch.int32 if got.dtype == torch.float32 else torch.int16
    return (got.view(itype).long() - want.view(itype).long()).abs().max().item()


def check_jacobi2d(H, W, dtype, device="cuda") -> dict:
    x = grid_inputs(H, W, dtype, device)
    return compare(_st.jacobi2d(x), ref.jacobi2d(x), JACOBI_TOL)


def check_fconv2d(H, W, f, dtype, device="cuda") -> dict:
    x, filt = conv_inputs(H, W, f, dtype, device)
    rtol = 8e-3 if dtype == torch.bfloat16 else 0.0
    return compare(_st.fconv2d(x, filt), ref.fconv2d(x, filt),
                   (rtol, conv_bound(x, filt)))


def check_softmax_rows(R, W, dtype, device="cuda", masked=False) -> dict:
    x = softmax_inputs(R, W, dtype, device, masked=masked)
    res = compare(_red.softmax_rows(x), ref.softmax_rows(x), SOFTMAX_TOL[dtype])
    res["resident"] = W <= _red.SOFTMAX_RESIDENT_MAX
    return res


def compare_expv(got, want) -> dict:
    """At most one ulp of the dtype apart (``limit_use`` is the ulps)."""
    res = compare(got, want, (0.0, float("inf")))
    res["ulps"] = ulps(got, want) if res["ok"] else float("inf")
    res["limit_use"] = res["ulps"] / 1.0
    res["ok"] = res["ok"] and res["ulps"] <= 1
    return res


def check_expv(n, dtype, device="cuda") -> dict:
    x = exp_inputs(n, dtype, device)
    return compare_expv(_red.expv(x), ref.expv(x))


#: the round-half edges of expv's range reduction, where k = round(x / ln2)
#: turns from n to n + 1: the f32 values within EXPV_EDGE_ULPS ulps of
#: (n + 1/2) ln 2 for every n in [-116, 116] (those past +-80 clip), then
#: +-80, +-inf and NaN
EXPV_EDGE_ULPS = 64
EXPV_EDGE_N = range(-116, 117)


def expv_edge_inputs(device="cuda") -> torch.Tensor:
    centre = torch.tensor([(n + 0.5) * math.log(2) for n in EXPV_EDGE_N],
                          dtype=torch.float32)
    steps = torch.arange(-EXPV_EDGE_ULPS, EXPV_EDGE_ULPS + 1, dtype=torch.int32)
    near = (centre.view(torch.int32)[:, None] + steps).reshape(-1).view(torch.float32)
    ends = torch.tensor([80.0, -80.0, math.inf, -math.inf, math.nan])
    return torch.cat([near, ends]).to(device)


def bit_diff(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Two f32 or bf16 tensors of positive values or NaNs, element by
    element: ``differ``, the elements whose bits differ (a NaN counts as
    equal to a NaN); ``nan_mismatch``, those a NaN on one side only;
    ``ulps``, the largest distance in ulps of the dtype over the others.
    ``ok`` is ``compare_expv``'s rule: at most one ulp, NaN where NaN."""
    if got.is_cuda:
        torch.cuda.synchronize()
    itype = torch.int32 if got.dtype == torch.float32 else torch.int16
    g, w = got.view(itype), want.view(itype)
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    res = {"n": got.numel(),
           "differ": int(((g != w) & ~(nan_g & nan_w)).sum()),
           "nan_mismatch": int((nan_g != nan_w).sum())}
    dist = torch.where(nan_g | nan_w, 0, (g.long() - w.long()).abs())
    res["ulps"] = int(dist.max()) if dist.numel() else 0
    res["ok"] = (got.shape == want.shape and got.dtype == want.dtype
                 and res["nan_mismatch"] == 0 and res["ulps"] <= 1)
    return res


def _merge(acc: dict, r: dict) -> dict:
    if not acc:
        return dict(r)
    return {"n": acc["n"] + r["n"], "differ": acc["differ"] + r["differ"],
            "nan_mismatch": acc["nan_mismatch"] + r["nan_mismatch"],
            "ulps": max(acc["ulps"], r["ulps"]), "ok": acc["ok"] and r["ok"]}


def f32_patterns(lo: int, count: int, device="cuda") -> torch.Tensor:
    """The f32 values of the ``count`` int32 bit patterns from ``lo``."""
    return (torch.arange(lo, lo + count, dtype=torch.int64, device=device)
            .to(torch.int32).view(torch.float32))


def bf16_patterns(device="cuda") -> torch.Tensor:
    """All 65,536 bf16 bit patterns."""
    return (torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=device)
            .to(torch.int16).view(torch.bfloat16))


def sweep_expv(run, want, device="cuda", chunk: int = 2 ** 28) -> dict:
    """``run`` against ``want`` (each an expv) on every f32 bit pattern,
    ``chunk`` at a time, on every bf16 one and on ``expv_edge_inputs``:
    ``bit_diff`` of each."""
    f32 = {}
    for lo in range(-2 ** 31, 2 ** 31, chunk):
        x = f32_patterns(lo, chunk, device)
        f32 = _merge(f32, bit_diff(run(x), want(x)))
        del x
    x, edges = bf16_patterns(device), expv_edge_inputs(device)
    return {"f32": f32, "bf16": bit_diff(run(x), want(x)),
            "f32 round-half edges": bit_diff(run(edges), want(edges))}


def dot_chain(n) -> int:
    """The longest f32 addition chain behind ``dotprod`` of n elements."""
    return _red.dot_chain(max(8, -(-n // 8) * 8))


def hier_chain(n, C, L) -> int:
    """The same behind ``dotprod_hier``: the lane partials' chains plus the
    log-tree's levels, one more for each odd straggler."""
    return (_red.dot_chain(_red.lane_len(n, C, L), C * L)
            + 2 * (C * L).bit_length())


def compare_dot(got, again, a, b, chain) -> dict:
    """``got`` against the f64 sum of a*b within ``dot_bound``; ``again``,
    a second call's result, must have the same bits."""
    if got.is_cuda:
        torch.cuda.synchronize()
    want = (a.double() * b.double()).sum().item()
    bound = dot_bound(a, b, chain)
    err = abs(got.item() - want)
    return {"max_abs_err": err, "rel_err": err / max(abs(want), 1e-300),
            "limit_use": err / bound, "rtol": 0.0, "atol": bound,
            "ok": got.dtype == torch.float32 and got.shape == () and err <= bound
            and bool(torch.equal(got, again))}


def dot_controls(a, b, chain) -> dict:
    """Two dots that compute in bf16, each read by ``compare_dot`` against
    the limit a kernel is held to at this chain: products rounded to bf16,
    and (for f32 inputs) inputs rounded to bf16.  Each must fail: its
    ``limit_use`` is above 1."""
    af, bf = a.float(), b.float()
    runs = {"bf16 products": lambda: (af * bf).bfloat16().float().sum()}
    if a.dtype == torch.float32:
        runs["bf16 inputs"] = lambda: (af.bfloat16().float()
                                       * bf.bfloat16().float()).sum()
    out = {}
    for name, run in runs.items():
        got = run()
        out[name] = compare_dot(got, got, a, b, chain)
    return out


def _check_dot(run, n, chain, dtype, device) -> dict:
    a, b = vec_inputs(n, dtype, device)
    res = compare_dot(run(a, b), run(a, b), a, b, chain)
    res["controls"] = {k: r["limit_use"] for k, r in dot_controls(a, b, chain).items()}
    a, b = sign_inputs(n, dtype, device)
    exact = (a.double() * b.double()).sum().item()
    res["exact_on_signs"] = run(a, b).item() == exact
    res["ok"] = (res["ok"] and res["exact_on_signs"]
                 and min(res["controls"].values()) > 1)
    return res


def check_dotprod(n, dtype, device="cuda") -> dict:
    return _check_dot(_red.dotprod, n, dot_chain(n), dtype, device)


def check_dotprod_hier(n, C, L, hierarchy, dtype, device="cuda") -> dict:
    """The whole pipeline: lane partials and the log-tree."""
    run = lambda a, b: _red.dotprod_hier(a, b, C=C, L=L, hierarchy=hierarchy)
    return _check_dot(run, n, hier_chain(n, C, L), dtype, device)
