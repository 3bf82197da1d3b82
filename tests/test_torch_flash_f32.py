"""The CPU side of the f32 flash-attention kernels on the tensor cores
(``tf32x3``: ``flash_tf32_kernel`` in ``csrc/flash_attention.cu``,
``flash_bwd_dq_tf32_kernel`` and ``flash_bwd_dkv_tf32_kernel`` in
``csrc/flash_attention_bwd.cu``): which kernels a call takes (``variant``,
``bwd_variant``, ``legal_variants``), what their blocks hold against the
card's limits, and a torch emulation of their arithmetic held to the plain
versions ``ref.attention`` and ``ref.attention_bwd`` and, for the forward,
to the JAX package's Pallas kernel in interpret mode.

The emulation follows the kernels' arithmetic: each f32 operand x of a
product is split into hi = TF32(x), rounded to nearest with ties away from
zero (``cvt.rna.tf32.f32``'s rounding: the low 13 bits of the f32 cleared
after adding 2^12 to the bit pattern), and lo = x - hi, which the tensor
core reads truncated to TF32 (its low 13 bits ignored), and each product
is taken as lo_x hi_y + hi_x lo_y + hi_x hi_y, summed in f32 (a tile's sum
added to its accumulator, as the backward's kernels add each tile's in
f32).  The forward: a 64-row q tile a block over ``tile_plan``'s 32-key
tiles in order, the online softmax in log2 units, O += P V with P split as
any operand.  The backward: the dq grid's two passes over the same walk in
32-key tiles (m, l and rowsum(P dP); then dS = P (dP - Dd), dQ += dS K),
the dkv grid's 64-key blocks over the G query heads and ``bwd_q_plan``'s
16-row q tiles (dV += P^T dO, dK += dS^T Q).  Tolerances:
``kernel_checks.ATTN_TOL[f32]`` (1e-5, 1e-5) and ``ATTN_BWD_TOL[f32]``
(1e-4, 1e-4), the card's checks.  One TF32 product a product (hi_x hi_y
alone) reads far past both limits: the last tests hold that, so a build
that dropped the lo terms would be seen.
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hopper, ref
from repro_torch.testing import kernel_checks as kc
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

F32 = torch.float32
FWD_TOL = kc.ATTN_TOL[F32]
BWD_TOL = kc.ATTN_BWD_TOL[F32]
CSRC = pathlib.Path(fa.__file__).parent / "csrc"


def _t3(name: str) -> str:
    """The ``namespace t3`` block (the tf32x3 kernels' constants) of
    ``csrc/<name>``."""
    return re.search(r"namespace t3 \{(.*?)\}  // namespace t3",
                     (CSRC / name).read_text(), re.S).group(1)


def _int(block: str, pattern: str) -> int:
    return int(re.search(pattern, block).group(1))


FWD_T3, BWD_T3 = _t3("flash_attention.cu"), _t3("flash_attention_bwd.cu")
BQ, BK = fa.WGMMA_BQ, fa.TF32_BK           # the forward's q rows and keys of a tile
DQ_BK = _int(BWD_T3, r"BQ = 64, BK = (\d+);")              # the dq grid's keys of a tile
DKV_BK, DKV_BQ = (_int(BWD_T3, r"BKV = (\d+), BQ2"),      # the dkv grid's keys and q rows
                  _int(BWD_T3, r"BQ2 = (\d+);"))
NEG = -1e30                                 # the kernels' NEG_INF


# -- which kernels ----------------------------------------------------------------

def _want(dtype, D, aligned, Sk):
    if D not in fa.WGMMA_HEAD_DIMS or Sk <= 0 or not aligned:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


@pytest.mark.parametrize("Sk", [0, 1, 70, 1024, 6404])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
def test_variants_by_dtype_head_dim_alignment_and_keys(dtype, D, aligned, Sk):
    """f32 at D = 64, 96, 128, aligned, Sk > 0 takes tf32x3 both ways;
    f32 elsewhere simt; every bf16 answer as before (stats from
    ``STATS_MIN_SK`` keys)."""
    want = _want(dtype, D, aligned, Sk)
    assert fa.variant(70, Sk, D, dtype, aligned) == want
    bwd = "stats" if want == "wgmma" and Sk >= fa.STATS_MIN_SK else want
    assert fa.bwd_variant(70, Sk, D, dtype, aligned) == bwd
    if aligned:
        legal = ("simt",) if want == "simt" else ("simt", want)
        assert fa.legal_variants(70, Sk, D, dtype) == legal


def test_the_check_cases_take_the_tensor_cores_in_f32():
    """Phase 3's and 3c's f32 cases at the llama3-8b heads and phi3-mini's
    take tf32x3; the smoke heads (16) stay on simt."""
    for _, S, _ in kc.FLASH_CASES:
        assert fa.variant(S, S, kc.HEAD_DIM, F32) == "tf32x3"
    for _, S, _ in kc.FLASH_BWD_CASES:
        assert fa.bwd_variant(S, S, kc.HEAD_DIM, F32) == "tf32x3"
    assert fa.variant(kc.PHI3_FLASH_S, kc.PHI3_FLASH_S, kc.PHI3_HEAD_DIM, F32) == "tf32x3"
    assert fa.variant(70, 70, 16, F32) == "simt"


def test_the_wrapper_states_the_kernels_constants():
    """The forward's block in ``flash_attention`` (``block_resources``,
    which analysis rule S3 holds to ``hopper``) is csrc ``t3::``'s; the
    backward's 64-row q tiles and 64-key blocks are the wgmma grids'."""
    assert fa.TF32_THREADS == _int(FWD_T3, r"THREADS = (\d+);")
    assert fa.TF32_STAGES == _int(FWD_T3, r"STAGES = (\d+);")
    assert (fa.WGMMA_BQ, fa.TF32_BK) == (_int(FWD_T3, r"BQ = (\d+), BK"),
                                         _int(FWD_T3, r"BQ = \d+, BK = (\d+);"))
    assert (fa.WGMMA_BQ, fa.WGMMA_BK) == (_int(BWD_T3, r"BQ = (\d+), BK"),
                                          _int(BWD_T3, r"BKV = (\d+),"))


def _bwd_smem(D: int) -> tuple[int, int]:
    """The backward's dynamic shared memory a block, dq and dkv, as csrc
    ``t3::SMEM_DQ`` and ``SMEM_DKV`` state it: rows of D f32 padded to
    ``LD`` (dq: Q, dO, K, V; dkv: K, V, Q and dO hi and lo, L2 and Dd)."""
    assert "SMEM_DQ = 4 * LD<D> * (2 * BQ + 2 * BK);" in BWD_T3
    assert "SMEM_DKV = 4 * (LD<D> * (2 * BKV + 4 * BQ2) + 2 * BQ2);" in BWD_T3
    ld = D + _int(BWD_T3, r"LD = D \+ (\d+);")
    return (4 * ld * (2 * fa.WGMMA_BQ + 2 * DQ_BK),
            4 * (ld * (2 * DKV_BK + 4 * DKV_BQ) + 2 * DKV_BQ))


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_the_blocks_fit_the_card(D):
    """The forward's block (Q hi and lo, two stages of K hi, K lo, V^T hi,
    V^T lo: 197,664 bytes at D = 128) launches, one an SM at D = 128; the
    backward's two grids (101,376 and 101,504 bytes at D = 128) hold two
    blocks an SM, as their launch bounds say."""
    r = fa.block_resources("tf32x3", 1, 32, 512, D)
    assert hopper.fits_block(r["smem"], r["threads"], r["static"])
    assert hopper.blocks_per_sm(r["smem"], r["threads"]) >= 1
    assert r["smem"] == 2 * 64 * D * 4 + 2 * 4 * 32 * D * 4 + 32 + 1024
    threads = _int(BWD_T3, r"NT = (\d+);")
    assert "__launch_bounds__(t3::NT, 2)" in (CSRC / "flash_attention_bwd.cu").read_text()
    for smem in _bwd_smem(D):
        assert hopper.fits_block(smem, threads, False)
        assert hopper.blocks_per_sm(smem, threads) >= 2
    if D == 128:
        assert _bwd_smem(D) == (101_376, 101_504)


def test_the_workspace_holds_a_stage_a_key_tile():
    """K hi, K lo, V^T hi, V^T lo of 32 keys a (b, kv head, tile), Sk
    rounded up to whole tiles."""
    assert fa.tf32_work_elems(1, 8, 512, 128) == 8 * 16 * 4 * 32 * 128
    assert fa.tf32_work_elems(2, 1, 33, 64) == 2 * 2 * 4 * 32 * 64


# -- the arithmetic -----------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from zero
    (2^12 added to the bit pattern's magnitude, the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """An f32 as the tensor core reads a TF32 operand: its low 13 bits
    ignored (truncated toward zero)."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def prod(a: torch.Tensor, b: torch.Tensor, products: int = 3) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products of the split
    operands, small first (``products=1``: TF32(a) @ TF32(b) alone)."""
    ah, bh = tf32(a), tf32(b)
    if products == 1:
        return ah @ bh
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _rows(t: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows r0 .. r0 + n - 1 of t (..., rows, D), zeros past the end."""
    out = t.new_zeros((*t.shape[:-2], n, t.shape[-1]))
    part = t[..., r0:r0 + n, :]
    out[..., :part.shape[-2], :] = part
    return out


def _visible(r0, rows, c0, cols, S, Sk, causal, window):
    i = torch.arange(r0, r0 + rows)[:, None]
    j = torch.arange(c0, c0 + cols)[None]
    vis = (i < S) & (j < Sk)
    if causal:
        vis &= i >= j
    if window:
        vis &= i - j < window
    return vis


def emulate_fwd(q, k, v, causal, window, products=3):
    """out as ``flash_tf32_kernel`` computes it (module docstring)."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    sl2 = math.log2(math.e) / math.sqrt(D)
    kq, vq = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
    out = torch.zeros((B, Hq, S, D))
    for q0 in range(0, S, BQ):
        Qt = _rows(q, q0, BQ)
        m = torch.full((B, Hq, BQ, 1), NEG)
        l = torch.zeros((B, Hq, BQ, 1))
        o = torch.zeros((B, Hq, BQ, D))
        for k0, masked in fa.tile_plan(q0, Sk, causal, window, bk=BK):
            Kt, Vt = _rows(kq, k0, BK), _rows(vq, k0, BK)
            s = prod(Qt, Kt.transpose(-1, -2), products)
            if masked:
                s = torch.where(_visible(q0, BQ, k0, BK, 1 << 30, Sk, causal, window), s, NEG)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - mx) * sl2)
            msl = torch.where(mx == NEG, 0.0, mx) * sl2
            p = torch.exp2(s * sl2 - msl)
            l = l * alpha + p.sum(-1, keepdim=True)
            m = mx
            o = o * alpha + prod(p, Vt, products)
        res = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
        rows = min(BQ, S - q0)
        out[:, :, q0:q0 + rows] = res[:, :, :rows]
    return out


def emulate_bwd(q, k, v, do, causal, window, products=3):
    """dq, dk, dv as ``flash_bwd_dq_tf32_kernel`` then
    ``flash_bwd_dkv_tf32_kernel`` compute them (module docstring)."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1 / math.sqrt(D)
    sl2 = math.log2(math.e) * scale
    kq, vq = (t.repeat_interleave(G, dim=1) for t in (k, v))
    L2 = torch.full((B, Hq, S), math.inf)
    Dd = torch.zeros((B, Hq, S))
    dq = torch.zeros((B, Hq, S, D))
    for q0 in range(0, S, BQ):                        # the dq grid
        Qt, Ot = _rows(q, q0, BQ), _rows(do, q0, BQ)
        m = torch.full((B, Hq, BQ, 1), NEG)
        l = torch.zeros((B, Hq, BQ, 1))
        pd = torch.zeros((B, Hq, BQ, 1))
        tiles = []
        for k0, masked in fa.tile_plan(q0, Sk, causal, window, bk=DQ_BK):   # pass 1
            Kt, Vt = _rows(kq, k0, DQ_BK), _rows(vq, k0, DQ_BK)
            s = prod(Qt, Kt.transpose(-1, -2), products)
            dp = prod(Ot, Vt.transpose(-1, -2), products)
            if masked:
                vis = _visible(q0, BQ, k0, DQ_BK, 1 << 30, Sk, causal, window)
                s = torch.where(vis, s, NEG)
            tiles.append((Kt, s, dp))
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - mx) * sl2)
            msl = torch.where(mx == NEG, 0.0, mx) * sl2
            p = torch.exp2(s * sl2 - msl)
            l = l * alpha + p.sum(-1, keepdim=True)
            pd = pd * alpha + (p * dp).sum(-1, keepdim=True)
            m = mx
        rows = min(BQ, S - q0)
        ok = l > 0
        L2[:, :, q0:q0 + rows] = torch.where(ok, m * sl2 + torch.log2(torch.where(ok, l, 1.0)),
                                             math.inf)[:, :, :rows, 0]
        Dd[:, :, q0:q0 + rows] = torch.where(ok, pd / torch.where(ok, l, 1.0),
                                             0.0)[:, :, :rows, 0]
        l2 = _rows(L2[..., None], q0, BQ)
        l2[:, :, rows:] = math.inf
        dd = _rows(Dd[..., None], q0, BQ)
        acc = torch.zeros((B, Hq, BQ, D))
        for Kt, s, dp in tiles:                        # pass 2
            p = torch.exp2(s * sl2 - l2)
            acc = acc + prod(p * (dp - dd), Kt, products)
        dq[:, :, q0:q0 + rows] = (acc * scale)[:, :, :rows]
    dk = torch.zeros((B, Hkv, Sk, D))
    dv = torch.zeros((B, Hkv, Sk, D))
    for k0 in range(0, Sk, DKV_BK):                   # the dkv grid
        Kt, Vt = _rows(k, k0, DKV_BK), _rows(v, k0, DKV_BK)
        gk = torch.zeros((B, Hkv, DKV_BK, D))
        gv = torch.zeros((B, Hkv, DKV_BK, D))
        for g in range(G):
            heads = torch.arange(Hkv) * G + g
            for q0, masked in fa.bwd_q_plan(k0, S, causal, window, Sk=Sk, bq=DKV_BQ,
                                            bk=DKV_BK):
                Qt, Ot = _rows(q[:, heads], q0, DKV_BQ), _rows(do[:, heads], q0, DKV_BQ)
                st = prod(Kt, Qt.transpose(-1, -2), products)
                dpt = prod(Vt, Ot.transpose(-1, -2), products)
                if masked:
                    vis = _visible(q0, DKV_BQ, k0, DKV_BK, S, Sk, causal, window).T
                    st = torch.where(vis, st, NEG)
                l2 = _rows(L2[:, heads, :, None], q0, DKV_BQ)
                l2[:, :, max(0, S - q0):] = math.inf
                dd = _rows(Dd[:, heads, :, None], q0, DKV_BQ)
                p = torch.exp2(st * sl2 - l2.transpose(-1, -2))
                ds = p * (dpt - dd.transpose(-1, -2))
                gv = gv + prod(p, Ot, products)
                gk = gk + prod(ds, Qt, products)
        n = min(DKV_BK, Sk - k0)
        dk[:, :, k0:k0 + n] = (gk * scale)[:, :, :n]
        dv[:, :, k0:k0 + n] = gv[:, :, :n]
    return dq, dk, dv


def _inputs(B, S, D, Hq=4, Hkv=1, seed=0, Sk=None):
    """q, k, v, do from numpy's randn (f32), as ``kernel_checks`` draws
    them on the card."""
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return tuple(torch.from_numpy(rng.standard_normal((B, h, n, D), dtype=np.float32))
                 for h, n in ((Hq, S), (Hkv, Sk), (Hkv, Sk), (Hq, S)))


#: (B, S, Hq, Hkv, causal, window): ragged prompts, windows across tile edges
#: (64, 100, 9), GQA 4/1 and 4/4, one without causality, cross-attention at
#: Sk != S
FWD_CASES = [(1, 256, 4, 1, True, None), (1, 223, 4, 1, True, None),
             (1, 445, 2, 2, True, 100), (2, 130, 4, 2, True, 9),
             (2, 70, 4, 2, False, 9)]


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", FWD_CASES, ids=str)
def test_forward_arithmetic_is_within_the_cards_limit(B, S, Hq, Hkv, causal, window, D):
    q, k, v, _ = _inputs(B, S, D, Hq, Hkv)
    got = emulate_fwd(q, k, v, causal, window)
    res = kc.compare(got, ref.attention(q, k, v, causal=causal, window=window), FWD_TOL)
    assert res["ok"], res


@pytest.mark.parametrize("Sk", [1, 63, 300])
def test_forward_arithmetic_across_a_context(Sk):
    """Non-causal over Sk keys that are not S (ragged key tiles)."""
    q, k, v, _ = _inputs(2, 70, 128, 4, 2, Sk=Sk)
    got = emulate_fwd(q, k, v, False, None)
    assert kc.compare(got, ref.attention(q, k, v, causal=False), FWD_TOL)["ok"]


@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_forward_arithmetic_is_the_pallas_kernels(D, window):
    """At a small f32 shape the emulation agrees with the JAX package's
    Pallas kernel, run as its own tests run it (interpret mode), causal and
    windowed, within ATTN_TOL[f32]."""
    q, k, v, _ = _inputs(1, 128, D, 4, 2, seed=3)
    got = emulate_fwd(q, k, v, True, window)
    want = jfa.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
                               window=window, interpret=True)
    res = kc.compare(got, torch.from_numpy(np.array(want)), FWD_TOL)
    assert res["ok"], res


#: FLASH_BWD_CASES at 4 q heads over 1 kv head (G = 4), the training length
#: cut to 256
BWD_CASES = [(1, 256, None), (1, 223, None), (1, 445, 100), (2, 256, 64)]


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("B,S,window", BWD_CASES)
def test_backward_arithmetic_is_within_the_cards_limit(B, S, window, D):
    q, k, v, do = _inputs(B, S, D)
    got = emulate_bwd(q, k, v, do, True, window)
    want = ref.attention_bwd(q, k, v, do, causal=True, window=window)
    for g, w in zip(got, want):
        res = kc.compare(g, w, BWD_TOL)
        assert res["ok"], res


def test_backward_arithmetic_without_causality_across_a_context():
    q, k, v, do = _inputs(2, 70, 64, 4, 2, Sk=130)
    got = emulate_bwd(q, k, v, do, False, None)
    want = ref.attention_bwd(q, k, v, do, causal=False)
    assert max(kc.compare(g, w, BWD_TOL)["limit_use"] for g, w in zip(got, want)) <= 1


def test_one_tf32_product_is_not_enough():
    """The reason for three products: with TF32(x) TF32(y) alone, the
    forward at the row 3b cut (4 q heads over 1, S = 512, D = 128, causal)
    and the backward at the training case's cut (1, 256) read far past
    their limits, while the three products stay inside."""
    q, k, v, do = _inputs(1, 512, 128)
    want = ref.attention(q, k, v, causal=True)
    three = kc.compare(emulate_fwd(q, k, v, True, None), want, FWD_TOL)["limit_use"]
    one = kc.compare(emulate_fwd(q, k, v, True, None, products=1), want, FWD_TOL)["limit_use"]
    assert three <= 1 and one > 10
    q, k, v, do = (t[:, :, :256] for t in (q, k, v, do))
    want = ref.attention_bwd(q, k, v, do, causal=True)
    three = max(kc.compare(g, w, BWD_TOL)["limit_use"]
                for g, w in zip(emulate_bwd(q, k, v, do, True, None), want))
    one = max(kc.compare(g, w, BWD_TOL)["limit_use"]
              for g, w in zip(emulate_bwd(q, k, v, do, True, None, products=1), want))
    assert three <= 1 < one


def test_tf32_rounds_to_nearest_ties_away():
    """The emulation's TF32: 10 mantissa bits kept; a value half-way
    between two TF32 values goes away from zero."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, 3.0], dtype=F32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, 3.0]
    y = torch.randn(1000)
    hi = tf32(y)
    assert bool(((hi - y).abs() <= y.abs() * 2.0 ** -11).all())
    # the remainder, read truncated: hi + lo within 2^-21 |y| (2^-22 but for
    # ties, where hi rounded away takes a whole half ulp)
    assert bool(((y - hi - tf32_read(y - hi)).abs() <= y.abs() * 2.0 ** -21).all())
    assert torch.equal(tf32_read(torch.tensor([1 + 2.0 ** -10 - 2.0 ** -20])),
                       torch.tensor([1.0]))
