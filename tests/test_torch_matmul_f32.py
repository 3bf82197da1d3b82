"""The CPU side of the f32 matmul on the tensor cores (``tf32x3``:
``matmul_tf32_kernel`` in ``csrc/matmul.cu``): which kernel a call takes
(``matmul.variant``), what its block holds against the card's limits and
the source's constants, and a torch emulation of its arithmetic held to the
plain version ``ref.matmul`` and to the JAX package's Pallas ``matmul`` in
interpret mode.

The emulation follows the kernel: each f32 operand x is split into hi =
TF32(x), rounded to nearest with ties away from zero (``cvt.rna``'s
rounding: 2^12 added to the bit pattern, the low 13 bits cleared), and lo
= x - hi, which the tensor core reads truncated to TF32; each k8 step
takes lo_a hi_b + hi_a lo_b + hi_a hi_b (the kernel's B^T A^T order, small
first), and each 32-deep K stage's twelve products are summed in a fresh
fragment, added to the running f32 sum.  Zeros past K, as TMA's fill.
Sums are f32 in the kernel's order; with ``chop`` each accumulation into
the fragment is instead rounded toward zero from its exact value, a model
of the tensor core's own accumulation, which keeps fewer low bits than a
rounded f32 add: under it one accumulator over K = 4,096 (1,536 products a
register) reads 1.13 of ``MATMUL_TOL[f32]`` and over 14,336 3.88, as the
f32 flash backward's dV read 1.083 over 1,536 products on the card, and a fresh
fragment a stage 0.019 and 0.026.  Without ``chop`` the emulation reads
0.016 (K = 4,096) and 0.023 (14,336) of the limit against ``ref.matmul``
(0.015 and 0.019 against the Pallas kernel); one TF32 product a product
(hi_a hi_b alone) 9.9x and 12.4x.  K is not cut: the count of
accumulations is the hazard; M and N are narrow (32 x 128).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import autotune as at
from repro_torch.kernels import hopper, ref
from repro_torch.kernels import matmul as mm
from repro_torch.testing import kernel_checks as kc
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

F32, BF16 = torch.float32, torch.bfloat16
TOL = kc.MATMUL_TOL[F32]
SRC = (pathlib.Path(mm.__file__).parent / "csrc" / "matmul.cu").read_text()
T3 = re.search(r"namespace t3 \{(.*?)\}  // namespace t3", SRC, re.S).group(1)


def _int(pattern: str) -> int:
    return int(re.search(pattern, T3).group(1))


# -- which kernel ---------------------------------------------------------------

def _want(dtype, M, K, N, aligned, trans):
    """The rule, written out: f32's forward at M > 8 and M N K >= 2^25 with
    16-byte rows on the tensor cores, else simt; bf16 as before."""
    if dtype == F32:
        tc = (trans == 0 and M > 8 and M * N * K >= 2 ** 25 and K % 4 == 0
              and N % 4 == 0 and aligned)
        return "tf32x3" if tc else "simt"
    if K <= 0 or K % 8 or N % 8 or not aligned or (trans == 2 and M % 8):
        return "simt"
    return "decode" if trans == 0 and M <= 8 else "wgmma"


@pytest.mark.parametrize("trans", [0, 1, 2])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096), (4100, 1028),
                                 (4104, 1032), (4102, 1032), (4096, 1030), (0, 8)])
@pytest.mark.parametrize("M", [1, 8, 9, 128, 333, 512])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_variant_by_dtype_rows_edges_alignment_and_product(dtype, M, K, N, aligned, trans):
    """f32 at M > 8, K > 0, K and N multiples of 4, aligned, the forward:
    tf32x3; f32 otherwise (decode batches, 4,102 or 1,030, K = 0, a view,
    the backward's products) simt; every bf16 answer as before."""
    assert mm.variant(M, K, N, dtype, aligned, trans) == _want(dtype, M, K, N, aligned, trans)


@pytest.mark.parametrize("M,K,N,want", [
    # the f32 smoke models' products (d_model 64, kv 32, d_ff 128, vocab 512)
    *[(M, K, N, "simt") for M in (9, 16, 42, 128)
      for K, N in ((64, 32), (64, 64), (64, 128), (128, 64), (64, 512))],
    (256, 256, 256, "simt"),              # kern/matmul_256, 1.7e7
    (16, 4096, 1024, "tf32x3"),           # the least llama3-8b product timed, 6.7e7
    (16, 2048, 1024, "tf32x3"),           # 2^25 itself
    (16, 2044, 1024, "simt")])            # just under it
def test_the_f32_boundary_by_work(M, K, N, want):
    """Below ``TF32_MIN_WORK`` (2^25 = M N K) the f32 forward stays on
    simt, where the card timed it the faster (the smoke models' products,
    kern/matmul_256); from it, tf32x3, as at every llama3-8b product timed
    from M = 16."""
    assert mm.TF32_MIN_WORK == 2 ** 25
    assert mm.variant(M, K, N, F32) == want


def test_the_check_shapes_take_the_tensor_cores_in_f32():
    """Row 2d's shape, every main-path f32 M > 8 of ``kernel_checks`` and
    the new ragged cases take tf32x3; the f32 decode batches, the ragged
    cases whose N is not a multiple of 4 and the backward's products stay
    on simt."""
    assert mm.variant(333, 4096, 14336, F32) == "tf32x3"
    for K, N in {**kc.MATMUL_KN, **kc.MAMBA_MATMUL_KN, **kc.PHI3_MATMUL_KN}.values():
        for M in kc.MATMUL_M + kc.MAMBA_ROWS + kc.MOE_M + kc.PHI3_ROWS:
            assert mm.variant(M, K, N, F32) == ("tf32x3" if M > 8 and M * K * N >= 2 ** 25 else "simt")
        assert mm.variant(512, N, K, F32, trans=1) == "simt"
        assert mm.variant(K, 512, N, F32, trans=2) == "simt"
    takes = {(M, K, N): mm.variant(M, K, N, dt) for M, K, N, dt in kc.MATMUL_RAGGED
             if dt == F32}
    for M in (9, 65, 130, 333):
        for K, N in ((4100, 1028), (4104, 1032)):
            assert takes[(M, K, N)] == "tf32x3"
    assert takes[(9, 4096, 1030)] == "simt"
    assert kc.MATMUL_UNALIGNED_F32 == (65, 4096, 1024)
    assert mm.variant(*kc.MATMUL_UNALIGNED_F32, F32, aligned=False) == "simt"


# -- the block --------------------------------------------------------------------

def test_the_wrapper_states_the_kernels_constants():
    """``matmul``'s tf32x3 tile, stage, ring, threads and shared memory are
    csrc ``t3::``'s (``block_resources``, which analysis rule S3 holds to
    ``hopper``, reads them)."""
    assert (mm.TF32_BM, mm.TF32_BN, mm.TF32_BK) == (
        _int(r"BM = (\d+), BN"), _int(r"BN = (\d+), BK"), _int(r"BK = (\d+);"))
    assert mm.TF32_STAGES == _int(r"STAGES = (\d+);")
    assert mm.TF32_THREADS == _int(r"THREADS = (\d+);")
    assert "SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;" in T3
    assert "STAGE_BYTES = 2 * A_BYTES + B_BYTES;" in T3
    assert "__launch_bounds__(t3::THREADS, 1)" in SRC
    assert mm.TF32_SMEM == 197_696
    # setmaxnreg's shares: the producer warpgroup's and the two consumers'
    # registers fit the SM's 65,536, each a multiple of 8
    prod, cons = _int(r"PRODUCER_REGS = (\d+),"), _int(r"CONSUMER_REGS = (\d+);")
    assert 128 * prod + 256 * cons <= 65_536 and prod % 8 == 0 and cons % 8 == 0


@pytest.mark.parametrize("M,K,N", [(9, 4096, 1024), (333, 4096, 14336),
                                   (4096, 14336, 4096), (130, 4104, 1032)])
def test_the_block_fits_the_card_unsplit(M, K, N):
    """One 197,696-byte block of 384 threads an SM, a block a 128 x 128
    tile of C; one plan (no split-K), a workspace for the prologue's A hi
    and lo, and the autotuner's legality (rule S3) takes it without a
    table."""
    r = mm.block_resources("tf32x3", M, K, N)
    assert hopper.fits_block(r["smem"], r["threads"], r["static"])
    assert hopper.blocks_per_sm(r["smem"], r["threads"]) == 1
    assert r["blocks"] == -(-M // 128) * -(-N // 128)
    assert mm.legal_splits("tf32x3", M, K, N) == (1,)
    # the prologue's A hi and lo, K rounded up to 8 (zeros past K)
    assert mm.tf32_work_elems(M, K) == 2 * M * (-(-K // 8) * 8)
    assert mm.plan("tf32x3", M, K, N) == (1, 0, 0)
    assert at.is_legal("matmul", (M, K, N), "float32", {"splits": 1})
    assert at.model_cost("matmul", (M, K, N), "float32", {"splits": 1})["core_us"] > 0


# -- the arithmetic ---------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """An f32 as the tensor core reads a TF32 operand: its low 13 bits
    ignored."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 values to f32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def emulate(a: torch.Tensor, b: torch.Tensor, products: int = 3, stage: int = 32,
            chop: bool = False) -> torch.Tensor:
    """``a @ b`` as ``matmul_tf32_kernel`` computes it (module docstring);
    ``stage`` the K depth of a fresh fragment (the kernel's 32; larger than
    K: one accumulator), ``products=1`` hi_a hi_b alone."""
    M, K = a.shape
    N = b.shape[1]
    S = -(-K // 8)                               # k8 steps, zeros past K
    ap = torch.zeros(M, 8 * S)
    ap[:, :K] = a
    bp = torch.zeros(8 * S, N)
    bp[:K] = b
    ah, bh = tf32(ap), tf32(bp)
    al, bl = tf32_read(ap - ah), tf32_read(bp - bh)
    rows = lambda x: x.view(M, S, 8).permute(1, 0, 2).double()
    cols = lambda x: x.view(S, 8, N).double()
    pairs = [(ah, bl), (al, bh), (ah, bh)] if products == 3 else [(ah, bh)]
    terms = [torch.bmm(rows(x), cols(y)) for x, y in pairs]    # exact k8 dots
    acc = torch.zeros(M, N)
    f = None
    for s in range(S):
        for t in terms:
            if f is None:
                f = _toward_zero(t[s]) if chop else t[s].float()
            else:
                f = _toward_zero(f.double() + t[s]) if chop else f + t[s].float()
        if (s + 1) % (stage // 8) == 0 or s == S - 1:
            acc = acc + f
            f = None
    return acc


def _inputs(M, K, N, seed=0):
    """``kernel_checks.matmul_inputs``' scales from numpy: a of unit scale,
    b at 1/sqrt(K), so each output is of unit scale."""
    rng = np.random.default_rng(seed + K)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    return a, b


def _use(got: torch.Tensor, want) -> float:
    return kc.compare(got, torch.from_numpy(np.array(want, np.float32)), TOL)["limit_use"]


@pytest.mark.parametrize("M,K,N", [(32, 4096, 128), (32, 14336, 128), (9, 4100, 36)])
def test_three_tf32_products_hold_the_f32_tolerance(M, K, N):
    """The kernel's arithmetic within ``MATMUL_TOL[f32]`` of ``ref.matmul``
    and of the JAX package's Pallas matmul (interpret mode), with room
    (0.016 and 0.023 of the limit at K = 4,096 and 14,336)."""
    a, b = _inputs(M, K, N)
    got = emulate(torch.from_numpy(a), torch.from_numpy(b))
    want = ref.matmul(torch.from_numpy(a), torch.from_numpy(b))
    pallas = jops.matmul(a, b, use_pallas=True)
    assert _use(got, want) < 0.1
    assert _use(got, pallas) < 0.1


@pytest.mark.parametrize("K", [4096, 14336])
def test_a_fresh_fragment_a_stage_against_a_truncating_accumulator(K):
    """Under the model of the tensor core's accumulation (each add rounded
    toward zero), twelve products a fragment and an f32 add a stage stay
    far inside the limit; one accumulator over all of K reads past it."""
    a, b = _inputs(32, K, 128)
    at_, bt = torch.from_numpy(a), torch.from_numpy(b)
    want = ref.matmul(at_, bt)
    assert _use(emulate(at_, bt, chop=True), want) < 0.1
    assert _use(emulate(at_, bt, chop=True, stage=8 * K), want) > 1.0


@pytest.mark.parametrize("K", [4096, 14336])
def test_one_tf32_product_fails_the_limit(K):
    """hi_a hi_b alone (TF32 in one product) reads several times past
    ``MATMUL_TOL[f32]``: a kernel that dropped its lo terms would be seen."""
    a, b = _inputs(32, K, 128)
    got = emulate(torch.from_numpy(a), torch.from_numpy(b), products=1)
    assert _use(got, ref.matmul(torch.from_numpy(a), torch.from_numpy(b))) > 3.0
