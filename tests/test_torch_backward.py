"""The plain versions of the three backward kernels (``kernels/ref.py``:
``rmsnorm_bwd``, ``attention_bwd``, ``matmul_grad_a`` and
``matmul_grad_b``), written as formulas, against ``jax.grad`` of
``repro.kernels.ops``' reference path on the same numpy inputs (CPU), and
the CPU-side pieces of the backward kernels' wrappers: which kernel a
backward product takes, the rmsnorm backward's blocks, and the checks the
wrappers make before the device.

Tolerance: rtol 1e-4, atol 1e-5 of the output's largest element.  Both
sides compute in f32 from the same inputs with sums in other orders (a few
ulp); a gradient that drops a term, a mask edge or a query head is off by
far more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention, launches, matmul, ref, rmsnorm

RTOL, ATOL_SHARE = 1e-4, 1e-5


def _draw(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL_SHARE * np.abs(want).max())


def _vjp(fn, inputs, dout):
    """jax.grad of sum(fn(*inputs) * dout) with respect to every input."""
    return jax.grad(lambda *xs: jnp.sum(fn(*xs) * dout),
                    argnums=tuple(range(len(inputs))))(*inputs)


@pytest.mark.parametrize("shape,eps", [((3, 32), 1e-6), ((2, 5, 64), 1e-5),
                                       ((1, 4099), 1e-5), ((64, 16), 1e-6)])
def test_rmsnorm_bwd_matches_jax_grad(shape, eps):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x, gamma, dy = 3 * _draw(rng, *shape), _draw(rng, shape[-1]), _draw(rng, *shape)
    want = _vjp(lambda a, g: jops.rmsnorm(a, g, eps=eps, use_pallas=False),
                (x, gamma), dy)
    dx, dgamma = ref.rmsnorm_bwd(torch.from_numpy(dy), torch.from_numpy(x),
                                 torch.from_numpy(gamma), eps)
    assert dx.dtype == torch.float32 and dgamma.shape == gamma.shape
    _close(dx, want[0])
    _close(dgamma, want[1])


@pytest.mark.parametrize("window", [None, 5, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_attention_bwd_matches_jax_grad(G, causal, window):
    """GQA with 1, 2 and 4 query heads a kv head; causal and not; windows
    inside and across the sequence."""
    rng = np.random.default_rng(G * 10 + causal + (window or 0))
    Hkv, S, D = 2, 13, 16
    q, k, v = _draw(rng, 2, Hkv * G, S, D), _draw(rng, 2, Hkv, S, D), _draw(rng, 2, Hkv, S, D)
    do = _draw(rng, 2, Hkv * G, S, D)
    want = _vjp(lambda a, b, c: jops.attention(a, b, c, causal=causal, window=window,
                                               use_pallas=False), (q, k, v), do)
    got = ref.attention_bwd(*map(torch.from_numpy, (q, k, v, do)),
                            causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("mkn", [(5, 12, 7), (33, 64, 16), (1, 9, 130)])
def test_matmul_products_match_jax_grad(mkn):
    M, K, N = mkn
    rng = np.random.default_rng(M)
    a, b, dc = _draw(rng, M, K), _draw(rng, K, N), _draw(rng, M, N)
    want = _vjp(lambda x, y: jops.matmul(x, y, use_pallas=False), (a, b), dc)
    _close(ref.matmul_grad_a(torch.from_numpy(dc), torch.from_numpy(b)), want[0])
    _close(ref.matmul_grad_b(torch.from_numpy(a), torch.from_numpy(dc)), want[1])


def test_attention_bwd_gives_no_gradient_to_rows_that_see_no_key():
    """Causal, window 2, 8 queries over 3 keys: rows 1 and 2 see two keys,
    rows 0 and 3 one (a softmax of one key has no gradient), rows 4.. none;
    the rows that see nothing add nothing to dk and dv."""
    rng = np.random.default_rng(5)
    q, do = (torch.from_numpy(_draw(rng, 1, 2, 8, 16)) for _ in range(2))
    k, v = (torch.from_numpy(_draw(rng, 1, 2, 3, 16)) for _ in range(2))
    dq, dk, dv = ref.attention_bwd(q, k, v, do, causal=True, window=2)
    seen = dq.abs().sum(-1).gt(0)[0]
    assert seen.tolist() == [[False, True, True, False] + [False] * 4] * 2
    cut = ref.attention_bwd(q[:, :, :4], k, v, do[:, :, :4], causal=True, window=2)
    assert torch.equal(dk, cut[1]) and torch.equal(dv, cut[2])


@pytest.mark.parametrize("M,K,N,trans,dtype,aligned,want", [
    (4096, 4096, 14336, 1, torch.bfloat16, True, "wgmma"),   # dX of wg/wi
    (4096, 4096, 14336, 2, torch.bfloat16, True, "wgmma"),   # dW of wg/wi
    (333, 4096, 1024, 1, torch.bfloat16, True, "wgmma"),
    (333, 4096, 1024, 2, torch.bfloat16, True, "simt"),      # A^T rows of 333
    (64, 4100, 1024, 1, torch.bfloat16, True, "simt"),       # K not a multiple of 8
    (64, 4096, 1030, 2, torch.bfloat16, True, "simt"),
    (64, 4096, 1024, 1, torch.bfloat16, False, "simt"),      # an unaligned view
    (4096, 4096, 4096, 1, torch.float32, True, "simt"),
    (4, 4096, 4096, 1, torch.bfloat16, True, "wgmma"),       # no decode form
])
def test_backward_products_pick_their_kernel(M, K, N, trans, dtype, aligned, want):
    assert matmul.variant(M, K, N, dtype, aligned, trans) == want


#: the backward's products of each llama3-8b projection over 4,096 tokens,
#: (M, K, N, trans) of the product (C (M, N), K the contraction)
TRAIN_PRODUCTS = {
    "wq/wo dX": (4096, 4096, 4096, 1), "wq/wo dW": (4096, 4096, 4096, 2),
    "wk/wv dX": (4096, 1024, 4096, 1), "wk/wv dW": (4096, 4096, 1024, 2),
    "wg/wi dX": (4096, 14336, 4096, 1), "wg/wi dW": (4096, 4096, 14336, 2),
    "mlp.wo dX": (4096, 4096, 14336, 1), "mlp.wo dW": (14336, 4096, 4096, 2),
}


@pytest.mark.parametrize("M,K,N,trans,want", [
    *[(*mknt, (1, -(-mknt[1] // 64) * 64, 0)) for mknt in TRAIN_PRODUCTS.values()],
    (333, 1024, 4096, 1, (1, 1024, 0)),     # 48 tiles: too few K steps to split
    (72, 4104, 1032, 1, (3, 1408, 5)),      # 5 tiles: 3 slices, the last ragged
    (136, 2056, 264, 2, (2, 1088, 4)),      # 4 tiles: 2 slices
    (4, 4096, 4096, 1, (3, 1408, 16)),
    (128, 4096, 1024, 0, (2, 2048, 8)),     # the forward's 128 x 128 tiles
], ids=str)
def test_backward_products_plan(M, K, N, trans, want):
    """(splits, slice, tickets) of the wgmma kernels: the backward's 128 x
    256 tiles fill the card unsplit at the training shapes; where they are
    few, K is cut into slices of whole K steps, none empty, one ticket an
    output tile, and tiles x slices within one wave of 132 SMs."""
    got = matmul.plan("wgmma", M, K, N, trans)
    assert got == want
    splits, slice_len, tickets = got
    bm, bn = matmul.wgmma_tile(trans)
    tiles = -(-M // bm) * -(-N // bn)
    assert (splits - 1) * slice_len < K <= splits * slice_len
    assert slice_len % matmul.WGMMA_BK == 0
    assert tickets == (tiles if splits > 1 else 0)
    assert splits == 1 or tiles * splits <= matmul.WGMMA_SMS


@pytest.mark.parametrize("M,N", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                                 (333, 1024), (130, 4104), (9, 33), (4104, 1032), (1, 8),
                                 (2056, 264), (129, 257), (2049, 7000)], ids=str)
def test_bwd_walk_visits_every_tile_once(M, N):
    """The grouped order holds each 128 x 256 output tile once, and a
    persistent grid of G blocks (block b takes tiles b, b + G, ...) makes
    each one once, whatever G."""
    walk = matmul.bwd_walk(M, N)
    tiles = {(m, n) for m in range(0, M, matmul.BWD_BM) for n in range(0, N, matmul.BWD_BN)}
    assert len(walk) == len(tiles) and set(walk) == tiles
    for G in (1, 7, 132, len(walk) + 5):
        taken = [walk[t] for b in range(min(G, len(walk))) for t in range(b, len(walk), G)]
        assert sorted(taken) == sorted(tiles)


def test_bwd_walk_groups_m_tiles_first():
    """GROUP_M M-tiles by every N-tile, M fastest, the last group short."""
    walk = matmul.bwd_walk(20 * 128, 3 * 256)
    G = matmul.BWD_GROUP_M
    assert walk[:G + 1] == [(m * 128, 0) for m in range(G)] + [(0, 256)]
    assert walk[3 * G:3 * G + 5] == [(m * 128, 0) for m in range(G, 20)] + [(G * 128, 256)]


#: the L2 budget of the backward's walk: of an H100's 50 MB of L2, what a
#: wave's operand strips may fill over an ``L2_WINDOW_K`` stretch of K (the
#: 132 persistent blocks start together and step through K at one rate, so
#: a strip one tile of the wave reads is read by the others while it is in
#: L2 if the wave's strips over that stretch fit; the rest holds outputs)
L2_BUDGET, L2_WINDOW_K = 40e6, 2048


def _wave_bytes(tiles, M, N, K, bm, bn):
    """bf16 bytes of the distinct A rows and B columns ``tiles`` ((m0, n0)
    of bm x bn output tiles) read over ``L2_WINDOW_K`` of K."""
    rows = sum(min(bm, M - m) for m in {m for m, _ in tiles})
    cols = sum(min(bn, N - n) for n in {n for _, n in tiles})
    return 2 * min(K, L2_WINDOW_K) * (rows + cols)


@pytest.mark.parametrize("name", list(TRAIN_PRODUCTS))
def test_bwd_walk_wave_fits_the_l2_budget(name):
    """Any 132 tiles in a row of the walk (the tiles a wave of persistent
    blocks holds at once) read at most ``L2_BUDGET`` of A and B; the
    forward kernel's walk (128 x 128 tiles, M fastest over all of M) reads
    more for dW at mlp.wo, whose X is 117 MB."""
    M, K, N, _ = TRAIN_PRODUCTS[name]
    walk, n = matmul.bwd_walk(M, N), matmul.WGMMA_SMS
    worst = max(_wave_bytes(walk[i:i + n], M, N, K, matmul.BWD_BM, matmul.BWD_BN)
                for i in range(max(1, len(walk) - n + 1)))
    assert worst <= L2_BUDGET
    if name == "mlp.wo dW":
        old = [(m, c) for c in range(0, N, 128) for m in range(0, M, 128)][:n]
        assert _wave_bytes(old, M, N, K, 128, 128) > L2_BUDGET


@pytest.mark.parametrize("R,want", [(1, 1), (2, 2), (263, 263), (264, 264),
                                    (4096, 264)])
def test_rmsnorm_backward_blocks(R, want):
    """One block a row up to two an H100 SM, each block's rows strided."""
    assert rmsnorm.bwd_blocks(R) == want


@pytest.mark.parametrize("D,dtype,aligned,want", [
    (4096, torch.bfloat16, True, "vec"),       # the training rows: 2 vectors a thread
    (4096, torch.float32, True, "vec"),
    (8192, torch.bfloat16, True, "vec"),       # 512 threads, the most
    (8192, torch.float32, True, "scalar"),     # 1024 threads: wider than it holds
    (4099, torch.bfloat16, True, "scalar"),    # not whole vectors
    (4096, torch.bfloat16, False, "scalar"),   # an unaligned view
    (8, torch.bfloat16, True, "vec"),
])
def test_rmsnorm_backward_path(D, dtype, aligned, want):
    assert rmsnorm.bwd_path(D, dtype, aligned) == want


@pytest.mark.parametrize("call,err,match", [
    (lambda: matmul.grad_a(torch.ones(4, 8), torch.ones(6, 8)), ValueError, "CUDA"),
    (lambda: matmul.grad_b(torch.ones(4, 8), torch.ones(4, 6)), ValueError, "CUDA"),
    (lambda: rmsnorm.backward(torch.ones(2, 8), torch.ones(2, 8), torch.ones(8), 1e-6),
     ValueError, "CUDA"),
    (lambda: rmsnorm.backward(torch.ones(2, 4), torch.ones(2, 8), torch.ones(8), 1e-6),
     ValueError, "dy like x"),
    (lambda: flash_attention.backward(*[torch.ones(1, 2, 3, 16)] * 4), ValueError, "CUDA"),
], ids=["grad_a cpu", "grad_b cpu", "rmsnorm cpu", "rmsnorm dy shape", "flash cpu"])
def test_backward_wrappers_refuse_what_they_do_not_take(call, err, match):
    """The backward launchers take CUDA tensors only, and launch nothing
    on what they refuse."""
    launches.reset()
    with pytest.raises(err, match=match):
        call()
    assert not any(launches.LAUNCHES.values())


@pytest.mark.parametrize("op", ["rmsnorm", "matmul", "attention"])
def test_cpu_seam_goes_through_the_functions(op):
    """With a trainable input, ops' CPU path records the Function (whose
    backward is the plain formula), and without one it does not."""
    from repro_torch.kernels import ops
    x = torch.randn(1, 2, 5, 16)
    calls = {"rmsnorm": (lambda t: ops.rmsnorm(t, torch.ones(16)), "RMSNormBackward"),
             "matmul": (lambda t: ops.dense(t, torch.ones(16, 3)), "MatmulBackward"),
             "attention": (lambda t: ops.attention(t, t, t), "FlashAttentionBackward")}
    fn, name = calls[op]
    assert fn(x).grad_fn is None
    out = fn(x.clone().requires_grad_())
    names = set()
    todo = [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None:
            names.add(type(node).__name__)
            todo += [n for n, _ in node.next_functions]
    assert name in names
