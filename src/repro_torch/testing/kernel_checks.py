"""Each kernel held against its plain version on the card, at the shapes
the llama3-8b serving path gives it (and phi3-mini's path, ``PHI3_*``,
mixtral-8x7b's, ``MOE_*`` and the windowed 4,608-token prompt, its train
step's, ``MOE_TRAIN_C`` and ``MIXTRAL_TRAIN_FLASH``, and mamba2-370m's,
``MAMBA_*``).
Used by ``chip_smoke.py`` and by the gpu-marked tests.

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
    units), ~2e-5: atol 1e-4, rtol 1e-5.  The tensor-core kernel
    (``tf32x3``) takes each product as three TF32 products of the
    operands' halves (hi = TF32(x), lo = x - hi read as TF32): what it
    drops, lo lo and lo's bits below TF32, is below ~2**-21 of each
    product, and products of random sign add it as a walk, ~1e-7 on these
    outputs; the tensor core's accumulation loses low bits at each add,
    which over one stage's twelve products in a fresh fragment, added to
    the sum in f32, stays at that size (over 1,536 products in one
    register it would reach the limit: ``tests/test_torch_matmul_f32.py``
    models both).  So the limit holds unchanged; one TF32 product alone
    (~2**-11 of each product) reads ~10x past it;
  * f32 rmsnorm: one D-long sum of squares, an approximate rsqrt and two
    products, ~1e-6 of the value: rtol 1e-5, atol 1e-6.
  * attention (flash and paged), f32: both sides form f32 dot products of
    D = 128 terms and f32 softmax sums over up to ~1000 keys (4,096 in
    mixtral's window) in different orders, and the exponentials differ by an
    ulp or two: outputs of order 0.1-1 move by ~1e-6 (over 4,096 keys the
    outputs are ~0.03 and the sums' walk ~4e-6 of their terms' ~1: a few
    1e-6), so rtol 1e-5, atol 1e-5;
  * attention, bf16: the same f32 math on the same bf16 inputs, rounded
    once to bf16: one ulp, rtol 8e-3, and atol 1e-5 for the f32 part.
A matmul that skips one 16-deep K tile moves a unit-scale output by ~3e-2,
an rmsnorm that mis-scales a row by 1 % moves each element by 1e-2 of its
value, and an attention that drops or adds one key of a few hundred moves a
row by ~1e-3: each fails in either dtype.

The backward kernels (``BWD_*``), each also called twice for the same
bits, at the training shapes (llama3-8b, 4 x 1024 tokens) and ragged ones:
  * the matmul's two products take the forward's tolerances: their inputs
    are drawn so that each output is of unit scale (dA = dC B^T with B at
    1/sqrt(N), dB = A^T dC with dC at 1/sqrt(M)), the sums run over up to
    14336 terms, as the forward's;
  * rmsnorm dx: the forward's rtol (one bf16 ulp, or f32 ~1e-6 of the
    value from the two D-long sums), atol 1e-5 on outputs of ~0.3;
  * rmsnorm dgamma (f32 from both dtypes): a sum over R = 4096 rows of
    unit-scale terms, values ~64, whose f32 sums in other orders differ by
    ~sqrt(R) 2**-24 64 ~ 3e-4: rtol 1e-4, atol 2e-3.  One row left out
    moves an element by ~1;
  * flash dq, dk, dv: f32 dot products of D terms, the softmax over up to
    1024 keys rebuilt from (m, l), dP - rowsum(P dP) and sums over up to
    1024 keys (and 4 query heads) in other orders: ~1e-5 on outputs of
    order 1, so rtol 1e-4, atol 1e-4 in f32, and one bf16 ulp (rtol 8e-3)
    on the same atol in bf16.  A key tile of 32 left out moves dq by ~0.2,
    and a 1 % error in rowsum(P dP) by ~1e-2.

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
    element) reach each branch's handling of -inf: those elements are 0;
A jacobi2d that drops a neighbour, an exp off by 2 ulp, a dot that loses
one product or rounds to bf16, or a softmax row normalised to 1 +- 1e-4
fails.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.models import layers as _layers

#: (K, N) of the llama3-8b projections
MATMUL_KN = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
             "wg/wi": (4096, 14336), "mlp.wo": (14336, 4096)}
#: M on the main paths: decode batches (1, 4 dense, 8 paged), a 128-token
#: prefill chunk, and whole prompts (333 ragged, 512)
MATMUL_M = (1, 4, 8, 128, 333, 512)
#: ragged (M, K, N, dtype): each bf16 kernel's M, N and K edges (K = 4104
#: leaves an 8-deep last K step, N = 1032 and 4104 an 8-wide last column
#: tile), tiny K and N, bf16 shapes whose rows are not 16-byte aligned
#: (the simt kernel), the f32 simt edges, and the f32 tf32x3 kernel's
#: edges: M 9, 65, 130 and 333 against its 128-row tile, K = 4100 and 4104
#: a 4- and an 8-deep last 32-deep stage, N = 1028 and 1032 a 4- and an
#: 8-wide last 128-column tile (each M N K at least ``matmul.TF32_MIN_WORK``,
#: 9 x 4100 x 1028 within 13 % of it); N = 1030 (rows of 4,120 bytes, which TMA
#: cannot map) stays on simt
MATMUL_RAGGED = (
    [(m, 4104, n, torch.bfloat16) for m in (5, 9, 65, 130) for n in (1032, 4104)]
    + [(1, 8, 8, torch.bfloat16), (16, 8, 8, torch.bfloat16),
       (5, 130, 33, torch.bfloat16), (9, 130, 33, torch.bfloat16),
       (12, 4100, 1030, torch.bfloat16)]
    + [(m, k, n, torch.float32) for m, k, n in
       ((1, 1, 1), (8, 130, 33), (9, 130, 33), (17, 33, 65), (3, 0, 5))]
    + [(m, k, n, torch.float32) for m in (9, 65, 130, 333)
       for k, n in ((4100, 1028), (4104, 1032))]
    + [(9, 4096, 1030, torch.float32)])
#: (M, K, N) of an f32 product whose A is a view one element into its
#: buffer (contiguous, not 16-byte aligned): simt takes it
#: (``check_matmul_view``)
MATMUL_UNALIGNED_F32 = (65, 4096, 1024)
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
#: the lens of chip_smoke.py's traced batch-8 paged decode step (phase 5d:
#: the 8 pool prompts of 71-445 tokens after their first decode tokens),
#: 1,836 tokens; testing/paged_probe.py and the gpu tests take them
DECODE_LENS = (459, 363, 307, 199, 216, 96, 111, 85)
#: whole-prompt prefill lengths (causal): the dense path's 35-223 and the
#: paged path's 71-445 tokens, ragged against the 64-row and 64-key tiles
FLASH_S = (1, 37, 223, 256, 333, 445, 512)
#: mixtral-8x7b's sliding window and the prompt past it that phase 8 serves
#: (its heads are llama3-8b's: 32 over 8 of 128)
MIXTRAL_WINDOW, MIXTRAL_LONG = 4096, 4608
#: (B, S, window): those, two sequences, sliding windows that end on a
#: tile edge (64) and inside tiles (100, 37), and mixtral's window at its
#: long prompt
FLASH_CASES = tuple((1, S, None) for S in FLASH_S) + (
    (2, 223, None), (1, 256, 64), (1, 333, 100), (1, 445, 37),
    (1, MIXTRAL_LONG, MIXTRAL_WINDOW))
#: mixtral-8x7b's expert products (phase 8): each expert runs on C =
#: ceil(N * 2 / 8 * 1.25) buffer rows, N the call's rows: a batch-4 decode
#: step (2), the 35- and 223-token prefills (11, 70) and the 4,608-token
#: one (1,440); its experts' (K, N) are llama3-8b's MLP ones
MOE_M = (2, 11, 70, 1440)
MOE_KN = {"wg/wi": MATMUL_KN["wg/wi"], "mlp.wo": MATMUL_KN["mlp.wo"]}
#: mixtral-8x7b's train step (4 x 1024 tokens, top-2 of 8 experts, factor
#: 1.25): C = 1,280 buffer rows an expert, the forward's M and the dX
#: product's, and the dW product's contraction; and a C that is not a
#: multiple of 8 (4,105 tokens), whose dW product takes simt
MOE_TRAIN_C = (1280, 1283)
#: mixtral's attention in its train step, (B, S, window): the window of
#: 4,096 over 1,024 tokens (every key in it), the llama3-8b heads
MIXTRAL_TRAIN_FLASH = (4, 1024, MIXTRAL_WINDOW)
#: mamba2-370m (d_model 1024, d_inner 2048, state 128, 32 SSD heads of 64):
#: (K, N) of its two projections, ``in_proj`` to 2 d_inner + 2 state + heads
#: = 4,384 columns (34 column tiles of 128 and a 32-wide edge tile) and
#: ``out_proj``; the rows the paths give them (a batch-4 decode step, a
#: 223-token prefill, the train step's tokens); rmsnorm at d_model and at
#: d_inner (the gated ``gnorm``)
MAMBA_MATMUL_KN = {"in_proj": (1024, 4384), "out_proj": (2048, 1024)}
MAMBA_ROWS = (4, 223, 4096)
MAMBA_NORM_D = (1024, 2048)


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
                 D=HEAD_DIM, bt=PAGED_BT, nblk=PAGED_NBLK, nb=PAGED_NB, shared=False):
    """q (B, Hkv, G, D); the pools as the model holds them, (NB, bt, Hkv, D)
    with block 0 zero, passed as (Hkv, NB, bt, D) views; tables whose rows
    share blocks with each other and point at the zero block inside their
    lengths (``shared``: every row on the longest row's table, as a prefill
    chunk's rows are); lens."""
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
    if shared:
        tables[:] = tables[int(np.argmax(lens))]
    elif B > 1:
        tables[-1, :8] = tables[-2, :8]          # a shared prefix of blocks
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


def moe_term_scale(p, x, cfg) -> torch.Tensor:
    """The sum of the magnitudes of the addends of each output element of
    ``layers.moe_layer(p, x, cfg)``, (B*S, d) f32: |x| plus, over the row's
    experts, gate * |expert output|."""
    N = x.shape[0] * x.shape[1]
    xn = _layers.rmsnorm(x, p["norm"], cfg.norm_eps)
    xf = xn.reshape(N, -1).to(torch.float32)
    scale = x.reshape(N, -1).abs().to(torch.float32)
    route = _layers.moe_route(p, xn, cfg)
    for gate, y in _layers.expert_terms(xf, route, p["wi"], p["wg"], p["wo"]):
        scale = scale + gate[:, None] * y.abs()
    return scale


def moe_tol(p, x, cfg) -> tuple:
    """(rtol, atol per element) of a bf16 MoE sublayer's output, kernel path
    against plain path, from the matmul's ``MATMUL_TOL``.  Each expert's
    SwiGLU is three bf16 products with a bf16 rounding after each, and the
    combine adds the experts' outputs and x: one ulp of the element (rtol
    |plain|) and atol as a product's; one ulp of each addend, not of their
    sum (two experts' outputs that cancel leave a small sum whose error is
    the addends'); and what the intermediate roundings carry through the
    next product (an ulp of some of the 14,336 elements of h moves every
    output of the row by a random sum), which scales with the row, not the
    element: rtol of the row's largest addend sum covers both."""
    rtol, atol = MATMUL_TOL[torch.bfloat16]
    row = moe_term_scale(p, x, cfg).amax(dim=1, keepdim=True)
    return rtol, atol + rtol * row


def mamba_scales(p, x, cfg, conv_state=None, ssm_state=None) -> tuple:
    """Magnitudes behind a Mamba sublayer's output and SSM state, f32, from
    the path ``x`` lies on: each output row's largest addend sum (|x| plus
    |g| @ |out_proj|, g the gated norm's output that enters ``out_proj``),
    and each state element's sum of its terms' magnitudes (the SSD over
    |xh|, |B| and |state_in|: dt and the decays are positive)."""
    B, S, d = x.shape
    m = _layers.mamba_mix(p, x, cfg, conv_state)
    y, _ = _layers._ssd_chunked(m.xh, m.dt, m.Bm, m.Cm, m.A, cfg.ssm_chunk,
                                ssm_state)
    _, s_abs = _layers._ssd_chunked(
        m.xh.abs(), m.dt, m.Bm.abs(), m.Cm, m.A, cfg.ssm_chunk,
        None if ssm_state is None else ssm_state.abs())
    y = (y + p["D"][None, None, :, None] * m.xh).reshape(B, S, -1)
    g = _layers.rmsnorm(y.to(x.dtype) * _layers.silu(m.z), p["gnorm"], cfg.norm_eps)
    row = x.abs().float().reshape(B * S, d) + \
        g.abs().float().reshape(B * S, -1) @ p["out_proj"].abs().float()
    return row.amax(dim=1, keepdim=True), s_abs


def mamba_tol(p, x, cfg, conv_state=None, ssm_state=None) -> dict:
    """(rtol, atol) of a bf16 Mamba sublayer's outputs, kernel path against
    plain path, by name.  ``out`` (B*S, d) as :func:`moe_tol` takes a MoE
    sublayer's: one ulp of the element, and ``MATMUL_TOL``'s rtol of the
    row's largest addend sum for what the intermediate roundings carry
    through ``out_proj``.  ``conv``, rows of ``in_proj``'s output:
    ``MATMUL_TOL``.  ``state`` (f32): 2**-6 of each element's terms'
    magnitude sum.  A term is dt x B times positive decays; x and B come
    from the bf16 conv of ``in_proj``'s output, each within about two bf16
    ulps (2**-7) of the other side's, dt from a bf16 dt within one, and a
    decay moves by at most 0.37 of dt's relative change, so a term within
    ~5.4 ulps: 2**-6 of its magnitude, the terms' errors adding with random
    signs."""
    rtol, atol = MATMUL_TOL[torch.bfloat16]
    row, s_abs = mamba_scales(p, x, cfg, conv_state, ssm_state)
    return {"out": (rtol, atol + rtol * row), "conv": (rtol, atol),
            "state": (0.0, 2.0 ** -6 * s_abs + 1e-30)}


def check_matmul(M, K, N, dtype, device="cuda") -> dict:
    """Called twice: the second call must give the same bits.  ``edge`` is
    the reading of the last ``N % 128`` columns alone (the forward's edge
    tile; all N if none)."""
    a, b = matmul_inputs(M, K, N, dtype, device)
    got, want = _mm.matmul(a, b), ref.matmul(a, b)
    res = _pair(got, _mm.matmul(a, b), want, MATMUL_TOL[dtype])
    lo = N - (N % _mm.WGMMA_BN or N)
    res["edge"] = compare(got[:, lo:], want[:, lo:], MATMUL_TOL[dtype])
    return res


def check_matmul_view(M, K, N, dtype, device="cuda") -> dict:
    """``check_matmul`` with A a view one element into its buffer
    (contiguous, its address not 16-byte aligned); ``variant`` names the
    kernel the wrapper takes for it."""
    a, b = matmul_inputs(M, K, N, dtype, device)
    flat = torch.empty(M * K + 1, dtype=dtype, device=device)
    flat[1:].copy_(a.reshape(-1))
    view = flat[1:].view(M, K)
    res = _pair(_mm.matmul(view, b), _mm.matmul(view, b), ref.matmul(view, b),
                MATMUL_TOL[dtype])
    res["variant"] = _mm.variant(M, K, N, dtype, view.data_ptr() % 16 == 0)
    return res


def check_rmsnorm(R, D, dtype, device="cuda") -> dict:
    """Called twice: the second call must give the same bits."""
    x, gamma = rmsnorm_inputs(R, D, dtype, device)
    return _pair(_rms.rmsnorm(x, gamma, EPS), _rms.rmsnorm(x, gamma, EPS),
                 ref.rmsnorm(x, gamma, EPS), RMSNORM_TOL[dtype])


def check_paged_attention(dtype, device="cuda") -> dict:
    args = paged_inputs(dtype, device)
    return compare(_pa.paged_attention(*args), ref.paged_attention(*args),
                    ATTN_TOL[dtype])


#: paged attention beyond PAGED_LENS, (name, lens, G, D, bt, shared): the
#: traced decode step; lens that fill one 64-token slice exactly, end one
#: token into the next, or are 0, beside full tables; one sequence; one
#: 128-row prefill chunk on one block table (the plan's one-slice case);
#: the smoke models' heads; G = 8 (two blocks of four rows a kv head);
#: phi3-mini's head of 96 (16-byte copies that are not whole passes)
PAGED_CASES = (
    ("decode", DECODE_LENS, 4, 128, 16, False),
    ("slice edges", (64, 65, 0, 128, 129, 1, 1024, 63), 4, 128, 16, False),
    ("B=1", (1000,), 4, 128, 16, False),
    ("chunk", tuple(range(318, 446)), 4, 128, 16, True),
    ("smoke G=1 D=16 bt=8", (0, 5, 8, 9, 40, 64, 65), 1, 16, 8, False),
    ("smoke G=2 D=16 bt=8", (0, 5, 8, 9, 40, 64, 65), 2, 16, 8, False),
    ("G=8 D=64 bt=32", (0, 5, 64, 65, 300), 8, 64, 32, False),
    ("G=1 D=96", (0, 7, 64, 200), 1, 96, 16, False),
)


def check_paged_case(case, dtype, device="cuda") -> dict:
    """One of ``PAGED_CASES`` against the plain version, called twice: the
    second call must give the same bits; ``plan`` names the split taken."""
    _, lens, G, D, bt, shared = case
    args = paged_inputs(dtype, device, lens=lens, G=G, D=D, bt=bt, shared=shared)
    got = _pa.paged_attention(*args)
    again = _pa.paged_attention(*args)
    res = compare(got, ref.paged_attention(*args), ATTN_TOL[dtype])
    res["same_bits"] = bool(torch.equal(got, again))
    res["ok"] = res["ok"] and res["same_bits"]
    res["plan"] = _pa.plan(len(lens), HKV, G, PAGED_NBLK * bt)
    return res


def check_flash_attention(S, dtype, window=None, device="cuda", B=1) -> dict:
    """The llama3-8b heads, causal, twice for the same bits; ``variant``
    names the kernel taken."""
    q, k, v = flash_inputs(S, dtype, device, B=B)
    run = lambda: _fa.flash_attention(q, k, v, causal=True, window=window)
    res = _pair(run(), run(), ref.attention(q, k, v, causal=True, window=window),
                ATTN_TOL[dtype])
    res["variant"] = _fa.variant(S, S, HEAD_DIM, dtype)
    return res


#: phi3-mini-3.8b's attention (d_model 3072): 32 query heads over 32 kv
#: heads of 96 (bf16 on the wgmma kernels, f32 on the simt ones); its
#: forward at a whole prompt of PHI3_FLASH_S and its backward at (B, S) =
#: PHI3_FLASH_BWD, the train step's batch and length, causal
PHI3_HQ, PHI3_HKV, PHI3_HEAD_DIM = 32, 32, 96
PHI3_FLASH_S = 512
PHI3_FLASH_BWD = (4, 1024)


def phi3_flash_inputs(S, dtype, device="cuda", seed=0, B=1):
    """q, k, v at phi3-mini's heads, (B, S, H, D) as (B, H, S, D) views."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((B, S, h, PHI3_HEAD_DIM), generator=g, device=device)
                 .to(dtype).transpose(1, 2) for h in (PHI3_HQ, PHI3_HKV, PHI3_HKV))


def check_flash_phi3(S, dtype, device="cuda") -> dict:
    """The forward at phi3-mini's heads, causal, twice for the same bits;
    ``variant`` names the kernel taken."""
    q, k, v = phi3_flash_inputs(S, dtype, device)
    run = lambda: _fa.flash_attention(q, k, v, causal=True)
    res = _pair(run(), run(), ref.attention(q, k, v, causal=True), ATTN_TOL[dtype])
    res["variant"] = _fa.variant(S, S, PHI3_HEAD_DIM, dtype)
    return res


#: head dim 96 in bf16 (the wgmma kernels on two boxes, the second
#: zero-filled past column 96), (B, S, Hq, Hkv, window), causal: phi3-mini's
#: train step (PHI3_FLASH_BWD at its heads), ragged prompts at its heads, a
#: window across tile edges, GQA 32/8; from inputs in the model's (B, S, H,
#: D) layout ("bshd", as views) and (B, H, S, D)-contiguous ("bhsd")
D96_CASES = ((*PHI3_FLASH_BWD, PHI3_HQ, PHI3_HKV, None),
             (1, 70, 32, 32, None), (1, 223, 32, 32, None), (1, 445, 32, 32, None),
             (2, 223, 32, 32, 100), (1, 445, 32, 8, None), (2, 70, 32, 8, 9))
D96_LAYOUTS = ("bshd", "bhsd")
#: columns of NaN after each output row that no store may touch
GUARD = 32


def _guarded(B, S, H, D, layout, device):
    """A (B, H, S, D) output view with GUARD columns of NaN after each row,
    in ``layout``, and the buffer it lies in."""
    shape = (B, S, H, D + GUARD) if layout == "bshd" else (B, H, S, D + GUARD)
    buf = torch.full(shape, float("nan"), dtype=torch.bfloat16, device=device)
    view = buf[..., :D]
    return (view.transpose(1, 2) if layout == "bshd" else view), buf


def check_flash_d96(B, S, Hq, Hkv, window, layout, device="cuda") -> dict:
    """The forward's out and the backward's dq, dk, dv at head dim 96, bf16,
    causal, each against its plain version over every head (ATTN_TOL,
    ATTN_BWD_TOL), twice for the same bits, each written into an output
    whose rows are followed by GUARD columns of NaN (a (B, S, H, D) layout
    puts the next head's columns there); ``guard_intact`` if every guard
    column is NaN after both calls.  ``variant`` names the kernels taken."""
    D = PHI3_HEAD_DIM
    q, k, v, do = attention_bwd_inputs(B, S, torch.bfloat16, Hq, Hkv, D, device)
    if layout == "bhsd":
        q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    bufs = []

    def run():
        (out, bo), (dq, bq), (dk, bk), (dv, bv) = (
            _guarded(B, S, h, D, layout, device) for h in (Hq, Hq, Hkv, Hkv))
        _fa._launch(q, k, v, out, True, window)
        _fa._launch_bwd(q, k, v, do, dq, dk, dv, True, window)
        bufs.extend((bo, bq, bk, bv))
        return out, dq, dk, dv

    got, again = run(), run()
    want = (ref.attention(q, k, v, causal=True, window=window),
            *ref.attention_bwd(q, k, v, do, causal=True, window=window))
    tols = (ATTN_TOL, ATTN_BWD_TOL, ATTN_BWD_TOL, ATTN_BWD_TOL)
    res = worst({name: _pair(g, a, w, t[torch.bfloat16]) for name, g, a, w, t in
                 zip(("out", "dq", "dk", "dv"), got, again, want, tols)})
    res["guard_intact"] = all(bool(torch.isnan(b[..., D:]).all()) for b in bufs)
    res["ok"] = res["ok"] and res["guard_intact"]
    res["variant"] = _fa.variant(S, S, D, torch.bfloat16)
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
#: the filter side; dot n; softmax (R, W), rows held in registers, and
#: "wide" rows past them, streamed twice (``reduction.softmax_plan``);
#: hier (C, L) machines, each under both hierarchies.
TABLE1 = {
    "table1-paper": {"jacobi": (256, 4096), "conv": (256, 4096, 7),
                     "dot": 4096, "softmax": [(64, 4096)],
                     "hier": [(16, 4)]},
    "table1-card": {"jacobi": (16384, 16384), "conv": (8198, 8198, 7),
                    "dot": 2 ** 28, "softmax": [(32768, 8192), (256, 2 ** 20)],
                    "hier": [(16, 4), (8, 8)]},
}
HIERARCHIES = ("two-level", "flat")
#: softmax_rows at each branch of ``reduction.softmax_plan`` beside
#: table1's: a short row in registers (7, 1000); aligned rows too long for
#: registers, streamed twice by one block a row (200, 40000); and rows that
#: are not 16-byte aligned, streamed by plain loads (3, 300001)
SOFTMAX_RAGGED = [(7, 1000), (3, 300001), (200, 40000)]
#: ragged shapes: tile and vector edges, each softmax branch;
#: "softmax_masked" takes masked rows (``softmax_inputs(masked=True)``)
RAGGED = {"jacobi": [(333, 1001)], "conv": [(72, 519, 3), (76, 523, 7)],
          "dot": [4099], "expv": [4099], "softmax": SOFTMAX_RAGGED,
          "softmax_masked": SOFTMAX_RAGGED}
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
    elements and at every eighth element."""
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


def _conv_check(x, filt) -> dict:
    rtol = 8e-3 if x.dtype == torch.bfloat16 else 0.0
    res = compare(_st.fconv2d(x, filt), ref.fconv2d(x, filt),
                  (rtol, conv_bound(x, filt)))
    (Hx, Wx), (fr, fc) = x.shape, filt.shape
    res["plan"] = _st.conv_plan(Hx - fr + 1, Wx - fc + 1, fr, fc, x.element_size())
    return res


def check_fconv2d(H, W, f, dtype, device="cuda") -> dict:
    return _conv_check(*conv_inputs(H, W, f, dtype, device))


#: fconv2d's filters beside table1's 7x7, (fr, fc, offset): every side from
#: 1 to 16, square (3, 5 and 7 unrolled, the rest the generic loop) and not
#: (fr x (17 - fr), fr x 3), over ragged outputs (32 + fr rows, 131 + 2 fc
#: + offset columns: partial tiles both ways, rows starting at every
#: alignment, so every copy width), from a base 16-byte aligned and one
#: element past it
CONV_FILTERS = tuple((fr, fc, off) for fr in range(1, 17)
                     for fc in sorted({fr, 17 - fr, 3}) for off in (0, 1))


def check_fconv2d_filter(fr, fc, off, dtype, device="cuda") -> dict:
    g = _gen(device, 3)
    Hx, Wx = 40 + fr, 131 + 2 * fc + off
    buf = torch.randn(Hx * Wx + off, generator=g, device=device).to(dtype)
    return _conv_check(buf[off:].view(Hx, Wx),
                       torch.randn((fr, fc), generator=g, device=device))


def check_softmax_rows(R, W, dtype, device="cuda", masked=False) -> dict:
    x = softmax_inputs(R, W, dtype, device, masked=masked)
    res = compare(_red.softmax_rows(x), ref.softmax_rows(x), SOFTMAX_TOL[dtype])
    res["branch"] = softmax_branch(x)
    return res


def softmax_branch(x) -> str:
    """The branch of ``reduction.softmax_plan`` that x takes."""
    W = x.shape[-1]
    item = x.element_size()
    aligned = x.data_ptr() % 16 == 0 and W * item % 16 == 0
    return _red.softmax_plan(W, item, aligned).branch


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



# -- the backward kernels -------------------------------------------------------

#: tokens a training step's matmuls see (batch 4 x seq 1024)
TRAIN_TOKENS = 4096
#: (rtol, atol) of the backward outputs, by output dtype
RMSNORM_BWD_TOL = {"dx": {torch.bfloat16: (8e-3, 1e-5), torch.float32: (1e-5, 1e-5)},
                   "dgamma": (1e-4, 2e-3)}
ATTN_BWD_TOL = {torch.bfloat16: (8e-3, 1e-4), torch.float32: (1e-4, 1e-4)}
#: rmsnorm backward (R, D): the training shape, rows not a multiple of the
#: kernel's blocks, one row, and a row that is not whole vectors
RMSNORM_BWD_CASES = ((TRAIN_TOKENS, D_MODEL), (333, D_MODEL), (1, D_MODEL),
                     (333, D_MODEL + 3))
#: matmul backward products (M, K, N) besides the projections at
#: TRAIN_TOKENS: ragged edges, bf16 shapes the wgmma forms do not take (K or
#: N not a multiple of 8: simt), and few output tiles, so that the wgmma
#: plan splits K (dA of (72, 1032, 4104) in 3 slices with a ragged last K
#: step, dB of (2056, 136, 264) in 2)
MATMUL_BWD_RAGGED = ((333, 4096, 1024), (130, 4104, 1032), (72, 4100, 1030),
                     (9, 130, 33), (72, 1032, 4104), (2056, 136, 264))
#: flash backward (B, S, window) at the llama3-8b heads, causal: the
#: training shape, a ragged prompt, windows
FLASH_BWD_CASES = ((4, 1024, None), (1, 223, None), (1, 445, 100), (2, 256, 64))
#: flash backward at the training length with the wgmma kernels' other head
#: dim (B, S, D), causal, the llama3-8b heads
FLASH_BWD_D64 = (4, 1024, 64)
#: phi3-mini-3.8b's matmuls and norms on its path (d_model 3072, d_ff 8192;
#: wq, wk, wv and wo all 3072 x 3072 over 32 kv heads of 96): (K, N) of its
#: projections, and the rows (M of the forward, R of rmsnorm) the path gives
#: them: a decode step, the whole PHI3_FLASH_S-token prefill, the train
#: step's TRAIN_TOKENS (the backward's at TRAIN_TOKENS alone)
PHI3_D_MODEL = 3072
PHI3_MATMUL_KN = {"wqkv/wo": (3072, 3072), "wg/wi": (3072, 8192),
                  "mlp.wo": (8192, 3072)}
PHI3_ROWS = (1, PHI3_FLASH_S, TRAIN_TOKENS)


def _pair(got, again, want, tol) -> dict:
    res = compare(got, want, tol)
    res["same_bits"] = bool(torch.equal(got, again))
    res["ok"] = res["ok"] and res["same_bits"]
    return res


def worst(parts: dict) -> dict:
    """One reading of several outputs: the largest error and limit use, ok
    and same bits if every output is; ``parts`` keeps each."""
    res = {"max_abs_err": max(r["max_abs_err"] for r in parts.values()),
           "rel_err": max(r["rel_err"] for r in parts.values()),
           "limit_use": max(r["limit_use"] for r in parts.values()),
           "ok": all(r["ok"] for r in parts.values()),
           "same_bits": all(r["same_bits"] for r in parts.values()),
           "parts": parts}
    first = next(iter(parts.values()))
    res["rtol"], res["atol"] = first["rtol"], first["atol"]
    return res


def matmul_bwd_inputs(M, K, N, dtype, which, device="cuda", seed=0):
    """``which`` "a": (dc (M, N), b (K, N) at 1/sqrt(N)); "b": (a (M, K),
    dc (M, N) at 1/sqrt(M)): unit-scale products."""
    g = torch.Generator(device=device).manual_seed(seed)
    if which == "a":
        dc = torch.randn((M, N), generator=g, device=device).to(dtype)
        b = (torch.randn((K, N), generator=g, device=device) / N ** 0.5).to(dtype)
        return dc, b
    a = torch.randn((M, K), generator=g, device=device).to(dtype)
    dc = (torch.randn((M, N), generator=g, device=device) / M ** 0.5).to(dtype)
    return a, dc


def check_matmul_bwd(M, K, N, dtype, which, device="cuda") -> dict:
    """dA = dC B^T (``which`` "a") or dB = A^T dC ("b") of ``(M, K) @ (K,
    N)``, twice; ``variant`` names the kernel taken."""
    x, y = matmul_bwd_inputs(M, K, N, dtype, which, device)
    if which == "a":
        run, want = _mm.grad_a, ref.matmul_grad_a(x, y)
        kind = _mm.variant(M, N, K, dtype, trans=1)
    else:
        run, want = _mm.grad_b, ref.matmul_grad_b(x, y)
        kind = _mm.variant(K, M, N, dtype, trans=2)
    res = _pair(run(x, y), run(x, y), want, MATMUL_TOL[dtype])
    res["variant"] = kind
    return res


def rmsnorm_bwd_inputs(R, D, dtype, device="cuda", seed=0):
    x, gamma = rmsnorm_inputs(R, D, dtype, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn((R, D), generator=g, device=device).to(dtype)
    return x, gamma, dy


def check_rmsnorm_bwd(R, D, dtype, device="cuda") -> dict:
    x, gamma, dy = rmsnorm_bwd_inputs(R, D, dtype, device)
    got = _rms.backward(dy, x, gamma, EPS)
    again = _rms.backward(dy, x, gamma, EPS)
    want = ref.rmsnorm_bwd(dy, x, gamma, EPS)
    tols = (RMSNORM_BWD_TOL["dx"][dtype], RMSNORM_BWD_TOL["dgamma"])
    res = worst({name: _pair(g, a, w, t) for name, g, a, w, t in
                 zip(("dx", "dgamma"), got, again, want, tols)})
    res["path"] = _rms.bwd_path(D, dtype)
    return res


def attention_bwd_inputs(B, S, dtype, Hq=HQ, Hkv=HKV, D=HEAD_DIM, device="cuda",
                         seed=0):
    """q, k, v as the model holds them, (B, S, H, D) as (B, H, S, D) views,
    and the output's gradient do, a (B, H, S, D) view likewise."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, h, D), generator=g, device=device)
                   .to(dtype).transpose(1, 2) for h in (Hq, Hkv, Hkv, Hq))
    return q, k, v, do


def check_flash_bwd(B, S, dtype, window=None, causal=True, Hq=HQ, Hkv=HKV,
                    D=HEAD_DIM, device="cuda") -> dict:
    """dq, dk, dv against ``ref.attention_bwd``, twice; ``variant`` names
    the kernels taken."""
    q, k, v, do = attention_bwd_inputs(B, S, dtype, Hq, Hkv, D, device)
    run = lambda: _fa.backward(q, k, v, do, causal=causal, window=window)
    got, again = run(), run()
    want = ref.attention_bwd(q, k, v, do, causal=causal, window=window)
    res = worst({name: _pair(g, a, w, ATTN_BWD_TOL[dtype]) for name, g, a, w in
                 zip(("dq", "dk", "dv"), got, again, want)})
    res["variant"] = _fa.bwd_variant(S, S, D, dtype)
    return res


# -- the cross-attention families (llama-3.2-vision-11b, seamless-m4t-large-v2)

#: cross-attention and the encoder, (name, B, S, Sk, Hq, Hkv, D): non-causal,
#: no window.  llama-3.2-vision-11b's 32 over 8 heads of 128 against its 6,404
#: image tokens (100 key tiles of 64 and a 4-key edge tile) from its
#: prompts of 512 and 223 tokens, its train step's 1,024, and a q tile of
#: 35 rows; seamless-m4t-large-v2's 16 over 16 heads of 64, its train
#: step's 1,024 decoder rows against 256 frames, and its encoder (S = Sk =
#: 256, and a ragged 200); ragged contexts of 1, 63 and 65 keys and one
#: past S by more than a tile; the smoke models' heads (4 over 2 of 16)
XATTN_FLASH_CASES = (
    ("vlm prefill", 4, 512, 6404, 32, 8, 128),
    ("vlm train", 4, 1024, 6404, 32, 8, 128),
    ("vlm q tile of 35", 4, 35, 6404, 32, 8, 128),
    ("vlm prompt of 223", 4, 223, 6404, 32, 8, 128),
    ("seamless train", 4, 1024, 256, 16, 16, 64),
    ("seamless encoder", 4, 256, 256, 16, 16, 64),
    ("seamless encoder ragged", 2, 200, 200, 16, 16, 64),
    ("Sk=1", 2, 70, 1, 32, 8, 128),
    ("Sk=63", 2, 70, 63, 16, 16, 64),
    ("Sk=65", 2, 70, 65, 32, 8, 128),
    ("Sk past S", 2, 70, 300, 16, 16, 64),
    ("smoke heads", 2, 9, 16, 4, 2, 16),
)
#: (K, N) of the cross-attention families' projections and the rows the
#: paths give them: llama-3.2-vision's ``wk``/``wv`` over its context rows
#: (4 x 6,404 = 25,616; its ``ctx_proj`` is ``torch.matmul``), and
#: seamless's (d_model 1,024, d_ff 8,192) at a batch-4 decode step, the
#: encoder's 4 x 256 rows and the train step's 4,096
XATTN_MATMUL = (("vlm wk/wv ctx", 25616, 4096, 1024),
                ("seamless wq/wo", 4, 1024, 1024), ("seamless wi", 4, 1024, 8192),
                ("seamless mlp.wo", 4, 8192, 1024),
                ("seamless wq/wo", 1024, 1024, 1024), ("seamless wi", 1024, 1024, 8192),
                ("seamless mlp.wo", 1024, 8192, 1024),
                ("seamless wq/wo", 4096, 1024, 1024), ("seamless wi", 4096, 1024, 8192),
                ("seamless mlp.wo", 4096, 8192, 1024))
#: the backward's products at the train steps' rows: the context's and the
#: decoder's (dX of mlp.wo at K = 8,192)
XATTN_MATMUL_BWD = (("vlm wk/wv ctx", 25616, 4096, 1024),
                    ("seamless wq/wo", 4096, 1024, 1024),
                    ("seamless wi", 4096, 1024, 8192),
                    ("seamless mlp.wo", 4096, 8192, 1024),
                    ("seamless enc wq/wo", 1024, 1024, 1024))
#: rmsnorm at seamless's d_model over a decode step's, the encoder's and the
#: train step's rows (D = 4,096, llama-3.2-vision's, is llama3-8b's)
XATTN_NORM = ((4, 1024), (1024, 1024), (4096, 1024))


def cross_inputs(B, S, Sk, Hq, Hkv, D, dtype, device="cuda", seed=0):
    """q (B, S, Hq, D), k and v (B, Sk, Hkv, D) and the output's gradient
    do (B, S, Hq, D), as the model holds them, passed as (B, H, S, D)
    views."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((B, n, h, D), generator=g, device=device)
                 .to(dtype).transpose(1, 2)
                 for n, h in ((S, Hq), (Sk, Hkv), (Sk, Hkv), (S, Hq)))


def check_flash_cross(B, S, Sk, Hq, Hkv, D, dtype, device="cuda") -> dict:
    """Cross-attention's forward and backward, non-causal and without a
    window, over Sk keys that are not S (or are, for the encoder): out, dq,
    dk, dv each against its plain version (ATTN_TOL, ATTN_BWD_TOL), each
    call twice for the same bits; k, v and dk, dv at Sk; where the
    backward is ``stats``, the statistics the forward keeps for it too
    (:func:`check_flash_stats`).  ``variant`` and ``bwd_variant`` name the
    kernels taken."""
    q, k, v, do = cross_inputs(B, S, Sk, Hq, Hkv, D, dtype, device)
    return _fwd_bwd(q, k, v, do, False, None)


#: the statistics the wgmma forward keeps under autograd for the stats
#: backward, against ref.attention_lse in f32: L (natural log) within 1e-4 +
#: 1e-5 |L| -- f32 sums of up to 6,404 terms in another order, ex2.approx and
#: log2f (~2^-22 relative) on scores that differ from the plain einsum's in
#: the last bits -- and the f32 output within ATTN_TOL's bf16 limit (P as
#: two bf16 halves, ~2^-16)
LSE_TOL = (1e-5, 1e-4)


def check_flash_stats(q, k, v, causal, window) -> dict:
    """The wgmma forward's :class:`Stats` under autograd: L2 / log2(e)
    against ``ref.attention_lse``'s L on the rows that see a key (+inf on
    the others and on the padding past S, exactly), and the f32 output
    against the plain one in f32; twice for the same bits."""
    S = q.shape[2]
    run = lambda: _fa._forward(q, k, v, causal, window, stats=True)[1]
    got, again = run(), run()
    out, lse = ref.attention_lse(q.float(), k.float(), v.float(), causal=causal,
                                 window=window)
    fin = torch.isfinite(lse)
    L = got.lse[..., :S] / math.log2(math.e)
    res = _pair(L[fin], again.lse[..., :S][fin] / math.log2(math.e), lse[fin], LSE_TOL)
    res["inf_rows_match"] = (torch.equal(torch.isinf(got.lse[..., :S]), ~fin)
                             and bool(torch.isinf(got.lse[..., S:]).all()))
    res["ok"] = res["ok"] and res["inf_rows_match"] and torch.equal(got.lse, again.lse)
    return worst({"lse": res, "o32": _pair(got.o32, again.o32, out,
                                           ATTN_TOL[torch.bfloat16])})


def _fwd_bwd(q, k, v, do, causal, window) -> dict:
    """out, dq, dk, dv of the kernels against the plain versions, each call
    twice; the forward's statistics where the backward is ``stats``."""
    B, Hq, S, D = q.shape
    Sk, dtype = k.shape[2], q.dtype
    fwd = lambda: _fa.flash_attention(q, k, v, causal=causal, window=window)
    bwd = lambda: _fa.backward(q, k, v, do, causal=causal, window=window)
    got, again = (fwd(), *bwd()), (fwd(), *bwd())
    want = (ref.attention(q, k, v, causal=causal, window=window),
            *ref.attention_bwd(q, k, v, do, causal=causal, window=window))
    tols = (ATTN_TOL, ATTN_BWD_TOL, ATTN_BWD_TOL, ATTN_BWD_TOL)
    parts = {name: _pair(g, a, w, t[dtype]) for name, g, a, w, t in
             zip(("out", "dq", "dk", "dv"), got, again, want, tols)}
    if _fa.bwd_variant(S, Sk, D, dtype) == "stats":
        parts["stats"] = check_flash_stats(q, k, v, causal, window)
    res = worst(parts)
    res["variant"] = _fa.variant(S, Sk, D, dtype)
    res["bwd_variant"] = _fa.bwd_variant(S, Sk, D, dtype)
    return res


#: the stats backward where the rule does not give it, (name, B, S, Sk, Hq,
#: Hkv, D, causal, window), bf16, each call run with it forced
#: (:func:`check_flash_stats_bwd`): causal prompts ragged and whole, a
#: window across tile edges, GQA 4/1 to 1/1 at every head dim, the training
#: shapes (llama3-8b's and phi3-mini's), non-causal with a window; and
#: mixtral's 4,608-token prompt with its 4,096 window, which the rule does
#: give it
STATS_FLASH_CASES = (
    ("llama3-8b train", 4, 1024, 1024, 32, 8, 128, True, None),
    ("phi3-mini train", 4, 1024, 1024, 32, 32, 96, True, None),
    ("prompt of 223", 1, 223, 223, 32, 8, 128, True, None),
    ("prompt of 37", 1, 37, 37, 32, 8, 128, True, None),
    ("window 100", 2, 445, 445, 32, 8, 128, True, 100),
    ("D=64 window 9", 2, 70, 70, 4, 2, 64, True, 9),
    ("D=96 G=4", 1, 445, 445, 32, 8, 96, True, None),
    ("full window 9", 2, 130, 130, 4, 1, 128, False, 9),
    ("mixtral prompt", 1, 4608, 4608, 32, 8, 128, True, 4096),
)


@contextlib.contextmanager
def forced_bwd_variant(kind):
    """Within the block every flash backward takes ``kind`` (``bwd_variant``
    replaced; a ``stats`` one finds the forward's statistics)."""
    rule = _fa.bwd_variant
    _fa.bwd_variant = lambda *a, **kw: kind
    try:
        yield
    finally:
        _fa.bwd_variant = rule


def check_flash_stats_bwd(B, S, Sk, Hq, Hkv, D, causal, window, device="cuda") -> dict:
    """:func:`check_flash_cross`'s readings for one of
    ``STATS_FLASH_CASES`` with the stats backward forced, bf16."""
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v, do = (torch.randn((B, n, h, D), generator=g, device=device)
                   .to(torch.bfloat16).transpose(1, 2)
                   for n, h in ((S, Hq), (Sk, Hkv), (Sk, Hkv), (S, Hq)))
    with forced_bwd_variant("stats"):
        return _fwd_bwd(q, k, v, do, causal, window)


def xattn_tol(p, x, ctx, cfg, cache=None) -> tuple:
    """(rtol, atol per row) of a bf16 cross-attention sublayer's output,
    kernel path against plain path, as :func:`moe_tol` takes a MoE
    sublayer's: one ulp of the element (rtol |plain|), ``MATMUL_TOL``'s
    atol, and rtol of the row's largest addend sum, |x| + |o| @ |wo| (o the
    attention's output that enters ``wo``), for what one-ulp differences in
    the bf16 intermediates (q, the context's K and V, o) carry through the
    products.  With ``cache`` the decode step's o, over the cached K/V."""
    rtol, atol = MATMUL_TOL[torch.bfloat16]
    B, S, d = x.shape
    hd = cfg.head_dim
    xn = _layers.rmsnorm(x, p["norm"], cfg.norm_eps)
    q = (xn.reshape(B * S, d).float() @ p["wq"].float()).reshape(B, S, cfg.n_heads, hd)
    k, v = cache if cache is not None else _layers.xattn_prefill_cache(p, ctx, cfg)
    o = ref.attention(q.transpose(1, 2), k.float().transpose(1, 2),
                      v.float().transpose(1, 2), causal=False)
    o = o.transpose(1, 2).reshape(B * S, cfg.n_heads * hd)
    row = x.abs().float().reshape(B * S, d) + o.abs() @ p["wo"].abs().float()
    return rtol, atol + rtol * row.amax(dim=1, keepdim=True)
