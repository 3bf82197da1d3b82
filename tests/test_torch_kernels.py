"""The port's kernel seam on the CPU (plain versions) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import rmsnorm as jrms
from repro_torch.kernels import ops
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

# f32: both sides accumulate in f32 and differ only in summation order.
# bf16: each side rounds its f32 result to bf16 once; an order difference
# can flip that rounding by one bf16 ulp (2**-8 relative), so 1e-2.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 7, 64])
@pytest.mark.parametrize("D", [64, 4096])
def test_rmsnorm_matches_pallas(D, R, dtype):
    rng = np.random.default_rng(D + R)
    xj, xt = _pair(rng.normal(size=(R, D)) * 3, dtype)
    g = rng.normal(size=(D,)).astype(np.float32)         # gamma stays f32
    want = jrms.rmsnorm(xj, jnp.asarray(g), eps=1e-5, interpret=True)
    got = ops.rmsnorm(xt, torch.from_numpy(g), 1e-5)
    assert got.dtype == TDT[dtype] and got.shape == (R, D)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(5, 64, 96), (33, 128, 130), (1, 48, 17)])
def test_matmul_matches_pallas(mkn, dtype):
    M, K, N = mkn
    rng = np.random.default_rng(M * K + N)
    aj, at = _pair(rng.normal(size=(M, K)), dtype)
    bj, bt = _pair(rng.normal(size=(K, N)) / np.sqrt(K), dtype)
    want = jops.matmul(aj, bj, use_pallas=True)
    got = ops.matmul(at, bt)
    assert got.dtype == TDT[dtype] and got.shape == (M, N)
    _close(got, want, dtype)


# (K, N) of the llama3-8b projections, and the M of the main paths
_PROJ = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
_MAIN_M = [1, 4, 8, 128, 333, 512]


@pytest.mark.parametrize("M", _MAIN_M)
@pytest.mark.parametrize("K,N", _PROJ)
def test_matmul_variant_on_the_main_path(K, N, M):
    """bf16 decode batches take the split-K kernel, prefill the wgmma one;
    f32 decode batches keep the CUDA-core kernel, f32 prefill takes the
    tensor cores in three TF32 products."""
    from repro_torch.kernels import matmul
    want = "decode" if M <= 8 else "wgmma"
    assert matmul.variant(M, K, N, torch.bfloat16) == want
    assert matmul.variant(M, K, N, torch.float32) == ("simt" if M <= 8 else "tf32x3")


@pytest.mark.parametrize("M,K,N,aligned", [(4, 4100, 4096, True),
                                           (4, 4096, 1030, True),
                                           (333, 130, 33, True),
                                           (4, 0, 8, True),
                                           (4, 4096, 4096, False),
                                           (333, 4096, 4096, False)])
def test_matmul_variant_unaligned_shapes_take_simt(M, K, N, aligned):
    from repro_torch.kernels import matmul
    assert matmul.variant(M, K, N, torch.bfloat16, aligned) == "simt"


@pytest.mark.parametrize("K,N", _PROJ + [(4104, 1032), (8, 8), (64, 64),
                                         (130 * 8, 33 * 8), (100000, 8),
                                         (4096, 1 << 20)])
def test_matmul_split_plan_tiles_k(K, N):
    """The slices tile K exactly once: each a multiple of the K step and at
    most the longest slice, the last one ragged but not empty, no more
    slices or blocks than allowed and more than half as many."""
    from repro_torch.kernels import matmul as mm
    splits, slice_len = mm.split_plan(K, N)
    assert slice_len % mm.DECODE_BK == 0 and 0 < slice_len <= mm.DECODE_SLICE_MAX
    bounds = [(s * slice_len, min((s + 1) * slice_len, K)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    cols = -(-N // mm.DECODE_BN)
    k_steps = -(-K // mm.DECODE_BK)
    forced = -(-K // mm.DECODE_SLICE_MAX)       # slices the longest slice needs
    assert splits <= max(mm.DECODE_MAX_SPLITS, forced)
    assert splits * cols <= mm.DECODE_TARGET_BLOCKS or splits in (1, forced)
    # cutting K into equal slices keeps more than half the slices allowed
    allowed = min(k_steps, mm.DECODE_MAX_SPLITS,
                  max(1, mm.DECODE_TARGET_BLOCKS // cols))
    assert splits * 2 > allowed or splits >= forced


def test_matmul_split_plan_of_the_projections():
    """The llama3-8b projections: 128-512 blocks, at most 16 slices."""
    from repro_torch.kernels import matmul as mm
    assert {kn: mm.split_plan(*kn) for kn in _PROJ} == {
        (4096, 4096): (16, 256), (4096, 1024): (16, 256),
        (4096, 14336): (4, 1024), (14336, 4096): (16, 896)}


@pytest.mark.parametrize("M", [9, 128, 223, 333, 512, 4096])
@pytest.mark.parametrize("K,N", _PROJ + [(4104, 1032), (8, 8), (64, 64)])
def test_matmul_wgmma_plan_tiles_k(K, N, M):
    """The wgmma kernel's slices tile K in whole 64-deep steps, none empty;
    it splits only where the output tiles are few, never past one wave, its
    most slices or its shortest slice, and takes the count of least modelled
    time among those."""
    from repro_torch.kernels import matmul as mm
    splits, slice_len = mm.wgmma_plan(M, K, N)
    assert slice_len % mm.WGMMA_BK == 0 and slice_len > 0
    assert (splits - 1) * slice_len < K <= splits * slice_len
    tiles = -(-M // mm.WGMMA_BM) * -(-N // mm.WGMMA_BN)
    assert splits <= mm.WGMMA_MAX_SPLITS
    assert splits == 1 or tiles * splits <= mm.WGMMA_SMS
    assert splits == 1 or slice_len >= mm.WGMMA_MIN_STEPS * mm.WGMMA_BK
    if tiles * 2 > mm.WGMMA_SMS:
        assert splits == 1
    steps = -(-K // mm.WGMMA_BK)
    cost = lambda n: -(-steps // n) * mm.WGMMA_STEP_US + (n - 1) * mm.WGMMA_SPLIT_US
    allowed = [n for n in range(1, mm.WGMMA_MAX_SPLITS + 1)
               if n == 1 or (tiles * n <= mm.WGMMA_SMS
                             and steps // n >= mm.WGMMA_MIN_STEPS)]
    assert cost(splits) <= min(cost(n) for n in allowed) + 1e-9
    splits_kind, slice_kind, tickets = mm.plan("wgmma", M, K, N)
    assert (splits_kind, slice_kind) == (splits, slice_len)
    assert tickets == (tiles if splits > 1 else 0)


def test_matmul_plans_of_the_main_path():
    """The prefill chunk (M = 128) splits every projection but wg/wi, whose
    112 tiles fill the card, and the long-K mlp.wo most; a 333-token prompt
    splits only wk/wv."""
    from repro_torch.kernels import matmul as mm
    chunk = {kn: mm.wgmma_plan(128, *kn)[0] for kn in _PROJ}
    assert chunk == {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 1,
                     (14336, 4096): 4}
    prompt = {kn: mm.wgmma_plan(333, *kn)[0] for kn in _PROJ}
    assert prompt == {(4096, 4096): 1, (4096, 1024): 2, (4096, 14336): 1,
                      (14336, 4096): 1}
    assert mm.plan("simt", 333, 4096, 4096) == (1, 0, 0)
    assert mm.plan("decode", 4, 4096, 1024) == (16, 256, 8)


# the whole-prompt lengths of the dense (35-223) and paged (71-445) paths
_PREFILL_S = [1, 35, 37, 64, 65, 223, 256, 333, 445, 512]


@pytest.mark.parametrize("S", _PREFILL_S)
def test_flash_variant_on_the_main_path(S):
    """bf16 prefills at llama3-8b's head dim take the wgmma kernel; f32
    the TF32 tensor-core kernel (three products)."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.variant(S, S, 128, torch.bfloat16) == "wgmma"
    assert fa.variant(S, S, 128, torch.float32) == "tf32x3"


@pytest.mark.parametrize("S,Sk,D,dtype,aligned,want", [
    (70, 70, 64, torch.bfloat16, True, "wgmma"),
    (70, 70, 96, torch.bfloat16, True, "wgmma"),
    (70, 70, 96, torch.float32, True, "tf32x3"),
    (70, 70, 96, torch.bfloat16, False, "simt"),
    (70, 70, 96, torch.float32, False, "simt"),
    (70, 0, 96, torch.bfloat16, True, "simt"),
    (70, 0, 96, torch.float32, True, "simt"),
    (70, 70, 16, torch.bfloat16, True, "simt"),
    (70, 70, 32, torch.bfloat16, True, "simt"),
    (70, 70, 64, torch.float32, True, "tf32x3"),
    (70, 0, 128, torch.bfloat16, True, "simt"),
    (223, 223, 128, torch.bfloat16, False, "simt"),
    (5, 300, 128, torch.bfloat16, True, "wgmma")])
def test_flash_variant_by_dtype_head_dim_and_alignment(S, Sk, D, dtype, aligned, want):
    from repro_torch.kernels import flash_attention as fa
    assert fa.variant(S, Sk, D, dtype, aligned) == want
    assert set(fa.WGMMA_HEAD_DIMS) <= set(fa.HEAD_DIMS)


def _visible(q0, Sk, causal, window, bq=64, n_keys=600):
    rows = torch.arange(q0, q0 + bq)[:, None]
    keys = torch.arange(n_keys)[None]
    vis = keys < Sk
    if causal:
        vis = vis & (keys <= rows)
    if window:
        vis = vis & (rows - keys < window)
    return vis


@pytest.mark.parametrize("window", [None, 1, 9, 37, 64, 100])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sk", [1, 37, 64, 65, 223, 445, 256, 6404])
def test_flash_tile_plan_walks_every_visible_key(Sk, causal, window):
    """Over every q tile: the tiles start on 64-key edges in order, cover
    every key some row of the tile sees, start no later than the window's
    edge tile and end at the causal limit, and are masked exactly where a
    row of the tile must not see one of their keys."""
    from repro_torch.kernels import flash_attention as fa
    for q0 in range(0, 512, fa.WGMMA_BQ):
        plan = fa.tile_plan(q0, Sk, causal, window)
        vis = _visible(q0, Sk, causal, window, n_keys=max(600, Sk + 64))
        starts = [k0 for k0, _ in plan]
        assert starts == sorted(starts) and all(k0 % fa.WGMMA_BK == 0 for k0 in starts)
        assert all(k0 < Sk for k0 in starts)
        covered = torch.zeros(vis.shape[1], dtype=torch.bool)
        for k0, masked in plan:
            covered[k0:k0 + fa.WGMMA_BK] = True
            tile = vis[:, k0:k0 + fa.WGMMA_BK]
            assert masked == (k0 + fa.WGMMA_BK > Sk or not bool(tile.all()))
        assert not bool((vis.any(0) & ~covered).any())
        # no tile past the causal limit, none wholly below every row's window
        if plan:
            assert plan[-1][0] < (min(Sk, q0 + fa.WGMMA_BQ) if causal else Sk)
            assert bool(vis[:, plan[-1][0]:].any()) or not bool(vis.any())


def test_flash_tile_plan_of_a_223_token_prompt():
    """The dense path's longest prompt: q tile t walks t + 1 tiles, and only
    its diagonal tile is masked; a 100-token window drops the tiles wholly
    below it."""
    from repro_torch.kernels import flash_attention as fa
    assert [fa.tile_plan(q0, 223, True, None) for q0 in (0, 64, 128, 192)] == [
        [(0, True)], [(0, False), (64, True)],
        [(0, False), (64, False), (128, True)],
        [(0, False), (64, False), (128, False), (192, True)]]
    assert fa.tile_plan(192, 223, True, 100) == [(64, True), (128, True), (192, True)]
    assert fa.tile_plan(192, 223, False, None)[-1] == (192, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_flattens_leading_dims(dtype):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.normal(size=(2, 7, 64)), dtype)
    wj, wt = _pair(rng.normal(size=(64, 40)) / 8, dtype)
    want = jops.dense(xj, wj, use_pallas=True)
    got = ops.dense(xt, wt)
    assert got.shape == (2, 7, 40)
    _close(got, want, dtype)


def test_cpu_tensors_never_launch():
    ops.reset_launches()
    ops.dense(torch.ones(3, 8), torch.ones(8, 4))
    ops.rmsnorm(torch.ones(3, 8), torch.ones(8))
    assert ops.LAUNCHES == {"rmsnorm": 0, "matmul": 0, "flash_attention": 0,
                            "paged_attention": 0, "dotprod": 0, "expv": 0,
                            "softmax_rows": 0, "jacobi2d": 0, "fconv2d": 0,
                            "rmsnorm_bwd": 0, "matmul_bwd": 0,
                            "flash_attention_bwd": 0}


def test_wrappers_and_seam_share_one_launch_counter():
    """The wrappers count where they launch; ``ops`` shows the same dict."""
    from repro_torch.kernels import (flash_attention, launches, matmul,
                                     paged_attention, reduction, rmsnorm,
                                     stencil)
    assert ops.LAUNCHES is launches.LAUNCHES is matmul.LAUNCHES \
        is rmsnorm.LAUNCHES is flash_attention.LAUNCHES \
        is paged_attention.LAUNCHES is reduction.LAUNCHES is stencil.LAUNCHES
    launches.LAUNCHES["matmul"] = 5
    launches.LAUNCHES["paged_attention"] = 2
    launches.LAUNCHES["fconv2d"] = 3
    launches.LAUNCHES["matmul_bwd"] = 4
    ops.reset_launches()
    assert launches.LAUNCHES == {"rmsnorm": 0, "matmul": 0,
                                 "flash_attention": 0, "paged_attention": 0,
                                 "dotprod": 0, "expv": 0, "softmax_rows": 0,
                                 "jacobi2d": 0, "fconv2d": 0, "rmsnorm_bwd": 0,
                                 "matmul_bwd": 0, "flash_attention_bwd": 0}


@pytest.mark.parametrize("kernel", ["matmul", "rmsnorm", "flash_attention",
                                    "paged_attention"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The kernel wrappers themselves never take a CPU tensor: there is no
    quiet switch to the plain version below ``ops``."""
    from repro_torch.kernels import (flash_attention, matmul, paged_attention,
                                     rmsnorm)
    with pytest.raises(ValueError, match="CUDA"):
        if kernel == "matmul":
            matmul.matmul(torch.ones(2, 3), torch.ones(3, 4))
        elif kernel == "rmsnorm":
            rmsnorm.rmsnorm(torch.ones(2, 3), torch.ones(3), 1e-6)
        elif kernel == "flash_attention":
            q = torch.ones(1, 2, 3, 16)
            flash_attention.flash_attention(q, q, q)
        else:
            pool = torch.zeros(1, 3, 8, 16)
            paged_attention.paged_attention(
                torch.ones(1, 1, 2, 16), pool, pool,
                torch.zeros(1, 2, dtype=torch.int32),
                torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("x,gamma,err,match", [
    (torch.ones(2, 8, dtype=torch.float16), torch.ones(8), TypeError, "f32/bf16"),
    (torch.ones(2, 8), torch.ones(8, dtype=torch.bfloat16), TypeError, "f32 gamma"),
    (torch.ones(8, 2).t(), torch.ones(8), ValueError, "contiguous"),
    (torch.ones(2, 8, dtype=torch.bfloat16)[:, ::2], torch.ones(4), ValueError,
     "contiguous"),
    (torch.ones(2, 8), torch.ones(8, 2)[:, 0], ValueError, "contiguous"),
    (torch.ones(2, 2, 8), torch.ones(8), ValueError, r"\(R, D\)"),
    (torch.ones(2, 8), torch.ones(7), ValueError, r"\(R, D\)"),
], ids=["f16", "bf16 gamma", "transposed", "strided bf16", "strided gamma", "3-d",
        "short gamma"])
def test_rmsnorm_kernel_refuses_what_it_does_not_take(x, gamma, err, match):
    """The CUDA rmsnorm's checks come before its device check (autograd's
    refusal first of all), so they hold here on CPU tensors; nothing
    launches."""
    from repro_torch.kernels import launches, rmsnorm
    launches.reset()
    with pytest.raises(err, match=match):
        rmsnorm.rmsnorm(x, gamma, 1e-6)
    assert not any(launches.LAUNCHES.values())


def test_jax_on_cpu():
    assert jax.devices()[0].platform == "cpu"


# -- paged attention's split plan and refusals (CPU side) ------------------------

def _paged_plan_shapes():
    """(B, Hkv, G, max_tokens): decode batches from 1 to 64 over the serving
    pool's 1,024-token tables and a 32K one; the 128-row prefill chunk;
    every smoke shape; G from 1 to 32 (1 to 8 blocks of rows); a table of
    one tile, and one of a single token."""
    return [(8, 8, 4, 1024), (1, 8, 4, 1024), (4, 8, 4, 1024), (32, 8, 4, 1024),
            (64, 8, 4, 1024), (1, 8, 4, 32768), (128, 8, 4, 1024), (128, 8, 4, 16),
            (2, 1, 2, 64), (4, 2, 1, 64), (3, 8, 32, 2048), (5, 4, 8, 512),
            (1, 1, 1, 1), (65535, 1, 1, 64), (1, 16383, 16, 64)]


@pytest.mark.parametrize("B,Hkv,G,T", _paged_plan_shapes(), ids=str)
def test_paged_plan_stays_within_hopper_limits(B, Hkv, G, T):
    """Every plan covers the table with whole 64-token tiles and no slice
    past it, launches a grid Hopper takes, keeps its shared memory within
    the 227 KB a block may have at every head dim and dtype, prefetches only
    where a slice has several tiles, and splits only while the card is not
    already full; the decode shapes fill it."""
    from repro_torch.kernels import paged_attention as pa
    p = pa.plan(B, Hkv, G, T)
    assert p.groups == -(-G // 4) and p.split_tokens % 64 == 0
    assert 1 <= p.splits <= pa.MAX_SPLITS
    assert p.splits * p.split_tokens >= T > (p.splits - 1) * p.split_tokens
    assert p.stages == (2 if p.split_tokens > 64 else 1)
    assert B < 2 ** 16 and Hkv * p.groups < 2 ** 16
    for D in pa.HEAD_DIMS:
        for item in (2, 4):
            assert pa.smem_bytes(D, item, p.stages) <= pa.SMEM_BYTES
    blocks = B * Hkv * p.groups
    if blocks >= pa.FILL_BLOCKS:
        assert p.splits == 1
    elif T >= 64 * pa.MAX_SPLITS:
        assert blocks * p.splits >= min(pa.TARGET_BLOCKS, blocks * pa.MAX_SPLITS) / 2
    assert pa.plan(B, Hkv, G, T) == p                   # shapes only


def test_paged_plan_at_the_serving_shapes():
    """Batch-8 decode over 1,024-token tables takes 16 slices of one tile;
    the 128-row chunk one slice over the whole table, prefetching."""
    from repro_torch.kernels import paged_attention as pa
    assert pa.plan(8, 8, 4, 1024) == pa.PagedPlan(16, 64, 1, 1)
    assert pa.plan(128, 8, 4, 1024) == pa.PagedPlan(1, 1024, 2, 1)


def _paged_args(**kw):
    a = {"q": torch.ones(2, 1, 2, 16), "kpool": torch.zeros(1, 3, 8, 16),
         "vpool": torch.zeros(1, 3, 8, 16),
         "tables": torch.zeros(2, 2, dtype=torch.int32),
         "lens": torch.ones(2, dtype=torch.int32)}
    a.update(kw)
    return a


@pytest.mark.parametrize("kw,err,match", [
    ({"q": torch.ones(2, 1, 2, 16, dtype=torch.float16)}, TypeError, "f32 or bf16"),
    ({"tables": torch.zeros(2, 2, dtype=torch.int64)}, TypeError, "int32"),
    ({"q": torch.ones(2, 1, 2, 24), "kpool": torch.zeros(1, 3, 8, 24),
      "vpool": torch.zeros(1, 3, 8, 24)}, ValueError, "limits"),
    ({"kpool": torch.zeros(1, 3, 3, 16), "vpool": torch.zeros(1, 3, 3, 16)},
     ValueError, "limits"),
    ({"kpool": torch.zeros(1, 3, 128, 16), "vpool": torch.zeros(1, 3, 128, 16)},
     ValueError, "limits"),
    ({"q": torch.ones(2, 1, 33, 16)}, ValueError, "limits"),
    ({"vpool": torch.zeros(1, 3, 16, 8).transpose(2, 3)}, ValueError,
     "one set of pool strides"),
    ({"lens": torch.ones(3, dtype=torch.int32)}, ValueError, "disagree"),
    ({}, ValueError, "CUDA"),
], ids=["f16", "int64 tables", "D=24", "bt=3", "bt=128", "G=33", "strides",
        "lens", "cpu"])
def test_paged_wrapper_refuses_what_it_does_not_take(kw, err, match):
    """The paged wrapper's checks come before its device check (autograd's
    refusal first of all), so they hold here on CPU tensors; nothing
    launches."""
    from repro_torch.kernels import launches, paged_attention as pa
    launches.reset()
    with pytest.raises(err, match=match):
        pa.paged_attention(**_paged_args(**kw))
    with pytest.raises(RuntimeError, match="no backward"):
        pa.paged_attention(**_paged_args(q=torch.ones(2, 1, 2, 16, requires_grad=True)))
    assert not any(launches.LAUNCHES.values())
