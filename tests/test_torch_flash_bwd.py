"""The CPU side of the flash-attention backward's kernels
(``csrc/flash_attention_bwd.cu``): which kernels a call takes
(``bwd_variant``), the q tiles the dkv kernel walks (``bwd_q_plan``), and a
torch emulation of the wgmma kernels' arithmetic held to the plain gradient
``ref.attention_bwd``; then the same emulation of the forward's
``flash_wgmma_kernel`` (``csrc/flash_attention.cu``) held to
``ref.attention``.

The backward's emulation follows the kernels step by step: bf16 q, k, v and do; each
product of bf16 operands summed in f32; the dq kernel's first pass (online
max, sum and rowsum(P dP) over the key tiles ``tile_plan`` gives, in
order, with 2^x and the log2-scaled scores), its second (P = 2^(s sl2 -
L2), dS = P (dP - Dd), dQ += dS K); the dkv kernel's walk over the G query
heads and ``bwd_q_plan``'s q tiles (dV += P^T dO, dK += dS^T Q); every sum
over tiles in the kernels' order.  Tiles hold the columns of
``box_plan(D)`` (D = 96: 128, zeros past 96): the K-side products run over
its ``qk_steps``, the N-side ones over every column, and only D columns are
stored.  P and dS enter their products as two bf16 halves, hi + lo, as the
kernels' ``split_p`` gives them.  Tolerance: ``kernel_checks.ATTN_BWD_TOL``
for bf16 (rtol 8e-3, atol 1e-4), the card's check.  The split reads
0.88-0.93 of that limit at ``EMU_CASES`` (D = 96 among them); with P and
dS rounded once to bf16 instead, the same comparison reads 28-67x it (the
last test holds one case of each head dim; 36x at D = 96).

The forward's: a 64-row q tile a block over ``tile_plan``'s key tiles in
order; S = Q K^T over the ``qk_steps`` k16 steps of the padded tiles,
summed in f32; the online softmax in log2 units with the scale of the
real D; O += P_hi V + P_lo V over every column the boxes hold; the rows
divided by their sums once; only ``store_cols`` columns written.
Tolerance: ``kernel_checks.ATTN_TOL`` for bf16 (rtol 8e-3, atol 1e-5).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.testing import kernel_checks as kc
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

BQ, BK = fa.WGMMA_BQ, fa.WGMMA_BK
TOL = kc.ATTN_BWD_TOL[torch.bfloat16]
FWD_TOL = kc.ATTN_TOL[torch.bfloat16]
NEG = -1e30                             # the kernels' NEG_INF


# -- which kernels ----------------------------------------------------------------

@pytest.mark.parametrize("S,Sk,D,dtype,aligned,want", [
    (1024, 1024, 128, torch.bfloat16, True, "wgmma"),    # the training shape
    (1024, 1024, 64, torch.bfloat16, True, "wgmma"),
    (70, 70, 128, torch.bfloat16, True, "wgmma"),
    (1, 1, 64, torch.bfloat16, True, "wgmma"),
    (1024, 1024, 96, torch.bfloat16, True, "wgmma"),     # phi3-mini's
    (1, 1, 96, torch.bfloat16, True, "wgmma"),
    (1024, 1024, 128, torch.float32, True, "tf32x3"),   # f32 on the tensor cores
    (1024, 1024, 96, torch.float32, True, "tf32x3"),
    (445, 445, 96, torch.bfloat16, False, "simt"),
    (70, 0, 96, torch.bfloat16, True, "simt"),
    (70, 70, 32, torch.bfloat16, True, "simt"),
    (70, 70, 16, torch.bfloat16, True, "simt"),
    (223, 223, 128, torch.bfloat16, False, "simt"),
    (70, 0, 128, torch.bfloat16, True, "simt"),
])
def test_bwd_variant_by_dtype_head_dim_and_alignment(S, Sk, D, dtype, aligned, want):
    assert fa.bwd_variant(S, Sk, D, dtype, aligned) == want


def test_every_bf16_backward_check_case_takes_the_wgmma_kernels():
    """Phase 3c's bf16 cases at the llama3-8b heads, and its D = 64 case at
    the training length, go through wgmma; their f32 twins through tf32x3."""
    for _, S, _ in kc.FLASH_BWD_CASES:
        assert fa.bwd_variant(S, S, kc.HEAD_DIM, torch.bfloat16) == "wgmma"
        assert fa.bwd_variant(S, S, kc.HEAD_DIM, torch.float32) == "tf32x3"
    _, S, D = kc.FLASH_BWD_D64
    assert fa.bwd_variant(S, S, D, torch.bfloat16) == "wgmma"


# -- the dkv kernel's walk --------------------------------------------------------

def _mask(S, Sk, causal, window):
    """ref's mask: (S, Sk), True where query i sees key j."""
    i = torch.arange(S)[:, None]
    j = torch.arange(Sk)[None]
    vis = torch.ones((S, Sk), dtype=torch.bool)
    if causal:
        vis &= i >= j
    if window:
        vis &= i - j < window
    return vis


@pytest.mark.parametrize("window", [None, 1, 9, 37, 64, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 37, 64, 65, 223, 445])
def test_bwd_q_plan_visits_every_visible_pair_once(S, causal, window):
    """Over every key tile: the q tiles start on 64-row edges, in order,
    each once; together they hold every (q row, key) pair ref's mask makes
    visible; none is one the masks hide entirely; and a tile is masked
    exactly where it holds a hidden pair (past S or Sk included)."""
    _walk_q_plans(S, S, causal, window)


@pytest.mark.parametrize("S, Sk", [(35, 6404), (512, 6404), (1024, 256), (64, 1),
                                   (65, 63), (256, 256), (70, 70)])
def test_bwd_q_plan_visits_every_visible_pair_once_across(S, Sk):
    """The same walk for cross-attention (non-causal, no window) over a
    context of Sk keys: vlm's 6,404 image tokens (a 4-key edge tile) against
    a q tile of fewer than 64 rows and against whole prompts, seamless's
    256 frames against 1,024 decoder rows, ragged Sk of 1 and 63; and the
    encoder's S = Sk, whole and ragged."""
    _walk_q_plans(S, Sk, False, None)


def _walk_q_plans(S, Sk, causal, window):
    vis = _mask(S, Sk, causal, window)
    seen = torch.zeros_like(vis, dtype=torch.int32)
    for k0 in range(0, Sk, BK):
        plan = fa.bwd_q_plan(k0, S, causal, window, Sk=Sk)
        starts = [q0 for q0, _ in plan]
        assert starts == sorted(set(starts)) and all(q0 % BQ == 0 for q0 in starts)
        assert all(0 <= q0 < S for q0 in starts)
        for q0, masked in plan:
            tile = vis[q0:q0 + BQ, k0:k0 + BK]
            assert bool(tile.any()), (k0, q0)
            whole = tile.shape == (BQ, BK) and bool(tile.all())
            assert masked == (not whole), (k0, q0)
            seen[q0:q0 + BQ, k0:k0 + BK] += 1
    assert bool((seen[vis] == 1).all())


def test_bwd_q_plan_of_a_223_token_prompt():
    """Causal: key tile t is seen by q tiles t.. (the diagonal one and the
    ragged last one masked); a 100-token window stops at the rows the
    tile's last key can reach; without causality every q tile."""
    assert fa.bwd_q_plan(0, 223, True, None) == [(0, True), (64, False), (128, False),
                                                 (192, True)]
    assert fa.bwd_q_plan(192, 223, True, None) == [(192, True)]
    assert fa.bwd_q_plan(0, 223, True, 100) == [(0, True), (64, True), (128, True)]
    assert [q0 for q0, _ in fa.bwd_q_plan(128, 223, False, None)] == [0, 64, 128, 192]
    # keys of a shorter key sequence: the tile past Sk's edge is masked
    assert fa.bwd_q_plan(64, 223, True, None, Sk=100) == [(64, True), (128, True),
                                                          (192, True)]


# -- the wgmma kernels' arithmetic ------------------------------------------------

def _split(x: torch.Tensor, rounding: str):
    """x as the bf16 operands the kernel feeds its product: hi + lo (the
    kernel's split_p), or one rounding."""
    hi = x.bfloat16().float()
    if rounding == "single":
        return (hi,)
    return hi, (x - hi).bfloat16().float()


def _tile(t: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows r0 .. r0 + n - 1 of t (..., rows, D) as the boxes of
    ``box_plan(D)`` hold them, TMA's way: each box from its first column,
    zeros past D and past the rows' end."""
    plan = fa.box_plan(t.shape[-1])
    out = t.new_zeros((*t.shape[:-2], n, plan.cols))
    part = t[..., r0:r0 + n, :]
    for c0, w in plan.boxes:
        out[..., :part.shape[-2], c0:c0 + w] = part[..., c0:c0 + w]
    return out


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_the_padded_columns_come_in_as_zeros(D):
    """A (B, S, H, D) view, as the model passes it, whose next columns in
    memory are the next head's: the loaded tile holds the row's D columns,
    then zeros, whatever lies after the row."""
    x = torch.randn((1, 70, 3, D)).transpose(1, 2)       # heads adjacent in memory
    tile = _tile(x, 64, BQ)
    assert torch.equal(tile[..., :6, :D], x[..., 64:70, :])
    assert not tile[..., D:].any() and not tile[..., 6:, :].any()


def _visible(r0, rows, c0, cols, S, Sk, causal, window):
    i = torch.arange(r0, r0 + rows)[:, None]
    j = torch.arange(c0, c0 + cols)[None]
    vis = (i < S) & (j < Sk)
    if causal:
        vis &= i >= j
    if window:
        vis &= i - j < window
    return vis


def emulate_bwd(q, k, v, do, causal, window, rounding="split", kind="wgmma", dd_from="f32"):
    """dq, dk, dv as the wgmma kernels compute them (module docstring), or
    with ``kind="stats"`` as the stats backward does: the same kernels
    reading L2 from the forward and Dd from its prologue
    (:func:`_fwd_stats`; ``dd_from`` the output Dd is taken from) instead
    of the dq kernel's first pass, so the key tiles are walked once."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    plan = fa.box_plan(D)                             # the tiles' columns
    scale = plan.scale
    sl2 = math.log2(math.e) * scale
    kk, cols = 16 * plan.qk_steps, plan.cols          # K-side and N-side widths
    qf, kf, vf, of = (t.float() for t in (q, k, v, do))
    kq = kf.repeat_interleave(G, dim=1)               # kv head of each q head
    vq = vf.repeat_interleave(G, dim=1)
    Sp = fa.stats_rows(S)
    L2 = torch.full((B, Hq, Sp), math.inf)
    Dd = torch.zeros((B, Hq, Sp))
    if kind == "stats":                               # the forward's, the prologue's
        L2, Dd = _fwd_stats(q, k, v, do, causal, window, dd_from)
    dq = torch.zeros((B, Hq, Sp, D))
    # the dq kernel: a block a (b, h, q tile)
    for q0 in range(0, S, BQ):
        Qt, Ot = _tile(qf, q0, BQ), _tile(of, q0, BQ)
        plan = fa.tile_plan(q0, Sk, causal, window)
        m = torch.full((B, Hq, BQ, 1), NEG)
        l = torch.zeros((B, Hq, BQ, 1))
        pd = torch.zeros((B, Hq, BQ, 1))
        tiles = []
        for k0, masked in plan:                       # pass 1 (stats: the products only)
            Kt, Vt = _tile(kq, k0, BK), _tile(vq, k0, BK)
            s = Qt[..., :kk] @ Kt[..., :kk].transpose(-1, -2)
            dp = Ot[..., :kk] @ Vt[..., :kk].transpose(-1, -2)
            if masked:
                vis = _visible(q0, BQ, k0, BK, 1 << 30, Sk, causal, window)
                s = torch.where(vis, s, NEG)
            tiles.append((k0, masked, Kt, s, dp))
            if kind == "stats":
                continue
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - mx) * sl2)
            msl = torch.where(mx == NEG, 0.0, mx) * sl2
            p = torch.exp2(s * sl2 - msl)
            l = l * alpha + p.sum(-1, keepdim=True)
            pd = pd * alpha + (p * dp).sum(-1, keepdim=True)
            m = mx
        if kind != "stats":
            rows = (torch.arange(q0, q0 + BQ) < S)[:, None]
            ok = (l > 0) & rows
            L2[:, :, q0:q0 + BQ] = torch.where(ok, m * sl2 + torch.log2(l), math.inf)[..., 0]
            Dd[:, :, q0:q0 + BQ] = torch.where(ok, pd / torch.where(ok, l, 1.0), 0.0)[..., 0]
        acc = torch.zeros((B, Hq, BQ, cols))
        for k0, masked, Kt, s, dp in tiles:           # pass 2
            p = torch.exp2(s * sl2 - L2[:, :, q0:q0 + BQ, None])
            ds = p * (dp - Dd[:, :, q0:q0 + BQ, None])
            for part in _split(ds, rounding):
                acc = acc + part @ Kt
        assert not acc[..., D:].any()                 # zero, and never stored
        dq[:, :, q0:q0 + BQ] = acc[..., :D] * scale
    # the dkv kernel: a block a (b, kv head, key tile); G heads, then q tiles
    dk = torch.zeros((B, Hkv, Sk, D))
    dv = torch.zeros((B, Hkv, Sk, D))
    for k0 in range(0, Sk, BK):
        Kt, Vt = _tile(kf, k0, BK), _tile(vf, k0, BK)
        gk = torch.zeros((B, Hkv, BK, cols))
        gv = torch.zeros((B, Hkv, BK, cols))
        for g in range(G):
            heads = torch.arange(Hkv) * G + g
            for q0, masked in fa.bwd_q_plan(k0, S, causal, window, Sk=Sk):
                Qt = _tile(qf[:, heads], q0, BQ)
                Ot = _tile(of[:, heads], q0, BQ)
                st = Kt[..., :kk] @ Qt[..., :kk].transpose(-1, -2)
                dpt = Vt[..., :kk] @ Ot[..., :kk].transpose(-1, -2)
                if masked:
                    vis = _visible(q0, BQ, k0, BK, S, Sk, causal, window).T
                    st = torch.where(vis, st, NEG)
                l2 = L2[:, heads, q0:q0 + BQ][:, :, None]
                p = torch.exp2(st * sl2 - l2)
                ds = p * (dpt - Dd[:, heads, q0:q0 + BQ][:, :, None])
                for part in _split(p, rounding):
                    gv = gv + part @ Ot
                for part in _split(ds, rounding):
                    gk = gk + part @ Qt
        assert not gk[..., D:].any() and not gv[..., D:].any()
        dk[:, :, k0:k0 + BK] = (gk[..., :D] * scale)[:, :, :Sk - k0]
        dv[:, :, k0:k0 + BK] = gv[:, :, :Sk - k0, :D]
    return (dq[:, :, :S].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _inputs(B, S, D, Hq=4, Hkv=1, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, h, S, D), dtype=np.float32))
                 .bfloat16() for h in (Hq, Hkv, Hkv, Hq))


#: FLASH_BWD_CASES at 4 q heads over 1 kv head (G = 4), the training length
#: cut to 256
EMU_CASES = [(1, 256, None), (1, 223, None), (1, 445, 100), (2, 256, 64)]


def _reading(got, want) -> float:
    return max(kc.compare(g, w, TOL)["limit_use"] for g, w in zip(got, want))


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("B,S,window", EMU_CASES)
def test_wgmma_arithmetic_is_within_the_cards_limit(B, S, window, D):
    q, k, v, do = _inputs(B, S, D)
    got = emulate_bwd(q, k, v, do, True, window)
    want = ref.attention_bwd(q, k, v, do, causal=True, window=window)
    for g, w in zip(got, want):
        res = kc.compare(g, w, TOL)
        assert res["ok"], res


def test_wgmma_arithmetic_without_causality():
    q, k, v, do = _inputs(2, 70, 64, Hq=4, Hkv=2)
    got = emulate_bwd(q, k, v, do, False, 9)
    want = ref.attention_bwd(q, k, v, do, causal=False, window=9)
    assert _reading(got, want) <= 1


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_one_bf16_rounding_of_p_and_ds_is_not_enough(D):
    """The reason P and dS go in as two halves: rounded once to bf16, the
    same comparison at the training case's cut (1, 256, causal) reads past
    its limit, while the split stays inside."""
    q, k, v, do = _inputs(1, 256, D)
    want = ref.attention_bwd(q, k, v, do, causal=True)
    split = _reading(emulate_bwd(q, k, v, do, True, None), want)
    single = _reading(emulate_bwd(q, k, v, do, True, None, "single"), want)
    assert split <= 1 < single


# -- the forward kernel's arithmetic ------------------------------------------------

def emulate_fwd(q, k, v, causal, window, scale=None, stats=False):
    """out as ``flash_wgmma_kernel`` computes it (module docstring), and the
    largest magnitude its accumulators hold past D; ``scale`` (default the
    plan's) replaces the scores' scale.  With ``stats`` also what it writes
    under autograd for the stats backward, ``(L2, o32)``: L2 = m sl2 +
    log2 l (+inf past S or with no visible key) in rows padded to 64, and
    the f32 output."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    plan = fa.box_plan(D)
    sl2 = math.log2(math.e) * (plan.scale if scale is None else scale)
    kk = 16 * plan.qk_steps                          # the K-side columns
    qf, kf, vf = (t.float() for t in (q, k, v))
    kq = kf.repeat_interleave(Hq // Hkv, dim=1)      # kv head of each q head
    vq = vf.repeat_interleave(Hq // Hkv, dim=1)
    out = torch.zeros((B, Hq, S, D))
    L2 = torch.full((B, Hq, fa.stats_rows(S)), math.inf)
    pad = 0.0
    for q0 in range(0, S, BQ):
        Qt = _tile(qf, q0, BQ)
        m = torch.full((B, Hq, BQ, 1), NEG)
        l = torch.zeros((B, Hq, BQ, 1))
        o = torch.zeros((B, Hq, BQ, plan.cols))
        for k0, masked in fa.tile_plan(q0, Sk, causal, window):
            Kt, Vt = _tile(kq, k0, BK), _tile(vq, k0, BK)
            s = Qt[..., :kk] @ Kt[..., :kk].transpose(-1, -2)
            if masked:
                vis = _visible(q0, BQ, k0, BK, 1 << 30, Sk, causal, window)
                s = torch.where(vis, s, NEG)
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - mx) * sl2)
            msl = torch.where(mx == NEG, 0.0, mx) * sl2
            p = torch.exp2(s * sl2 - msl)
            l = l * alpha + p.sum(-1, keepdim=True)
            m = mx
            o[..., :D] *= alpha                      # the kernel scales D columns
            for part in _split(p, "split"):
                o = o + part @ Vt
        pad = max(pad, float(o[..., D:].abs().max()) if plan.cols > D else 0.0)
        res = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
        rows = min(BQ, S - q0)
        out[:, :, q0:q0 + rows] = res[:, :, :rows, :plan.store_cols]
        lr = torch.where(l > 0, m * sl2 + torch.log2(torch.where(l > 0, l, 1.0)), math.inf)
        L2[:, :, q0:q0 + rows] = lr[:, :, :rows, 0]
    if stats:
        return out.to(q.dtype), pad, (L2, out)
    return out.to(q.dtype), pad


#: (B, S, Hq, Hkv, causal, window): ragged prompts, a window across tile
#: edges, GQA 4/1 and 4/4 (phi3-mini's G = 1), one sequence without causality
FWD_CASES = [(1, 70, 4, 4, True, None), (1, 223, 4, 1, True, None),
             (1, 445, 2, 2, True, 100), (2, 130, 4, 2, True, 9),
             (2, 70, 4, 2, False, 9)]


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", FWD_CASES, ids=str)
def test_forward_arithmetic_on_the_boxes_is_within_the_cards_limit(B, S, Hq, Hkv, causal,
                                                                   window, D):
    """Every head compared; the accumulators' columns past D stay exactly 0."""
    q, k, v, _ = _inputs(B, S, D, Hq, Hkv)
    got, pad = emulate_fwd(q, k, v, causal, window)
    res = kc.compare(got, ref.attention(q, k, v, causal=causal, window=window), FWD_TOL)
    assert res["ok"], res
    assert pad == 0.0


def test_the_padded_width_as_the_scale_is_outside_the_limit():
    """The reason the scale is passed from D: 1/sqrt(128) for a head of 96
    moves the output far past the check's limit."""
    q, k, v, _ = _inputs(1, 130, 96, 2, 2)
    want = ref.attention(q, k, v, causal=True)
    right, _ = emulate_fwd(q, k, v, True, None)
    wrong, _ = emulate_fwd(q, k, v, True, None, scale=1 / math.sqrt(128))
    assert kc.compare(right, want, FWD_TOL)["ok"]
    assert kc.compare(wrong, want, FWD_TOL)["limit_use"] > 10


# -- the stats backward: the forward's statistics, one walk of the dq grid -------------

def _fwd_stats(q, k, v, do, causal, window, dd_from="f32"):
    """L2 from the wgmma forward under autograd (:func:`emulate_fwd`) and
    Dd = rowsum(dO o) as ``flash_bwd_dd_kernel`` takes it from the
    forward's f32 output (or, with ``dd_from="bf16"``, from the bf16 one),
    rows padded to 64."""
    B, Hq, S, _ = q.shape
    out, _, (L2, o32) = emulate_fwd(q, k, v, causal, window, stats=True)
    o = o32 if dd_from == "f32" else out.float()
    Dd = torch.zeros((B, Hq, fa.stats_rows(S)))
    Dd[:, :, :S] = (do.float() * o).sum(-1)
    return L2, Dd


def _cross(B, S, Sk, D, Hq=4, Hkv=1, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, h, n, D), dtype=np.float32))
                 .bfloat16() for n, h in ((S, Hq), (Sk, Hkv), (Sk, Hkv), (S, Hq)))


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window", FWD_CASES, ids=str)
def test_forward_statistics_are_the_plain_l(B, S, Hq, Hkv, causal, window, D):
    """What the forward keeps under autograd: its L2 / log2(e) equal to
    ref.attention_lse's L within 2e-6 (f32 sums in another order; +inf
    where ref's is, and on the padding past S), its f32 output the bf16
    one before rounding."""
    q, k, v, _ = _inputs(B, S, D, Hq, Hkv)
    got, _, (L2, o32) = emulate_fwd(q, k, v, causal, window, stats=True)
    _, lse = ref.attention_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(o32.to(q.dtype), got)
    assert torch.equal(torch.isinf(L2[..., :S]), torch.isinf(lse))
    assert bool(torch.isinf(L2[..., S:]).all())
    fin = torch.isfinite(lse)
    torch.testing.assert_close(L2[..., :S][fin] / math.log2(math.e), lse[fin],
                               rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("B,S,window", EMU_CASES)
def test_stats_backward_arithmetic_is_within_the_cards_limit(B, S, window, D):
    """The stats backward (L2 from the forward, Dd from its f32 output, one
    walk of the dq grid) within ATTN_BWD_TOL at the wgmma kernels' cases."""
    q, k, v, do = _inputs(B, S, D)
    got = emulate_bwd(q, k, v, do, True, window, kind="stats")
    want = ref.attention_bwd(q, k, v, do, causal=True, window=window)
    for g, w in zip(got, want):
        res = kc.compare(g, w, TOL)
        assert res["ok"], res


#: cross-attention at cut widths, (B, S, Sk, D): vlm's 32/8 heads cut to
#: 4/1, its 6,404 image tokens cut to 700 (a 60-key edge tile), a q tile
#: of 35 rows; seamless's decoder rows against fewer frames; the encoder
STATS_CROSS_CASES = [(1, 130, 700, 128), (1, 35, 700, 128), (2, 200, 77, 64),
                     (1, 200, 200, 96)]


@pytest.mark.parametrize("B,S,Sk,D", STATS_CROSS_CASES)
def test_stats_backward_across_is_within_the_cards_limit(B, S, Sk, D):
    """Non-causal, no window, Sk != S: the forward and the stats backward."""
    q, k, v, do = _cross(B, S, Sk, D)
    got, _ = emulate_fwd(q, k, v, False, None)
    assert kc.compare(got, ref.attention(q, k, v, causal=False), FWD_TOL)["ok"]
    want = ref.attention_bwd(q, k, v, do, causal=False)
    assert _reading(emulate_bwd(q, k, v, do, False, None, kind="stats"), want) <= 1


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_dd_from_the_bf16_output_is_not_enough(D):
    """The reason the forward keeps its output in f32 under autograd: with
    Dd = rowsum(dO o) taken from the bf16 output (FlashAttention-2's way)
    the training case's cut (1, 256, causal) reads past its limit (14-39x
    at EMU_CASES), while Dd from the f32 output stays inside."""
    q, k, v, do = _inputs(1, 256, D)
    want = ref.attention_bwd(q, k, v, do, causal=True)
    f32 = _reading(emulate_bwd(q, k, v, do, True, None, kind="stats"), want)
    bf16 = _reading(emulate_bwd(q, k, v, do, True, None, kind="stats", dd_from="bf16"), want)
    assert f32 <= 1 < bf16
