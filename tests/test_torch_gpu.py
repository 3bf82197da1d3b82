"""The port's kernels against their plain versions on the card, at the
llama3-8b serving shapes and at the paper's Table I shapes (the checks of
``chip_smoke.py``'s kernel phases), the backward kernels at the training
shapes (phase 3c) and the smoke train step against the CPU (phase 4b),
their launch counts, what their wrappers refuse, and (phase 11) a
checkpointed smoke run on the card resumed bit for bit and an async save
against the in-place step.

Marked ``gpu``: they skip where there is no CUDA card.  Run them on the
machine with the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import pytest
import torch

from repro_torch.kernels import (flash_attention, launches, matmul, ops,
                                 paged_attention, reduction, ref, rmsnorm,
                                 stencil)
from repro_torch.testing import kernel_checks as kc

DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def cuda():
    # decided here, at run time, so every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain f32 products in full f32, as chip_smoke.py sets them
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", kc.MATMUL_M)
@pytest.mark.parametrize("proj", list(kc.MATMUL_KN))
def test_matmul_kernel_matches_plain(cuda, proj, M, dtype):
    K, N = kc.MATMUL_KN[proj]
    res = kc.check_matmul(M, K, N, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", kc.MOE_M)
@pytest.mark.parametrize("proj", list(kc.MOE_KN))
def test_matmul_kernel_moe_rows(cuda, proj, M, dtype):
    """mixtral-8x7b's expert products at each expert's buffer rows: within
    the limit, the same bits twice."""
    K, N = kc.MOE_KN[proj]
    res = kc.check_matmul(M, K, N, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", kc.RMSNORM_R)
def test_rmsnorm_kernel_matches_plain(cuda, R, dtype):
    res = kc.check_rmsnorm(R, kc.D_MODEL, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", kc.PHI3_ROWS)
@pytest.mark.parametrize("proj", list(kc.PHI3_MATMUL_KN))
def test_matmul_kernel_phi3_widths(cuda, proj, M, dtype):
    """phi3-mini's projections at a decode step's, the prefill's and the
    train step's rows: within the limit, the same bits twice."""
    K, N = kc.PHI3_MATMUL_KN[proj]
    res = kc.check_matmul(M, K, N, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", kc.PHI3_ROWS)
def test_rmsnorm_kernel_phi3_width(cuda, R, dtype):
    res = kc.check_rmsnorm(R, kc.PHI3_D_MODEL, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", kc.RMSNORM_R)
@pytest.mark.parametrize("case", ["unaligned", "ragged D"])
def test_rmsnorm_kernel_scalar_path(cuda, case, R, dtype):
    """A view one element into its buffer (contiguous, not 16-byte aligned)
    and a row that is not whole 16-byte vectors take the scalar path: within
    the limit of the plain version, and the same bits on a second call."""
    D = kc.D_MODEL if case == "unaligned" else kc.D_MODEL + 3
    flat, gamma = kc.rmsnorm_inputs(1, R * D + 1, dtype, cuda)
    x = flat[0, 1:].view(R, D) if case == "unaligned" else flat[0, :R * D].view(R, D)
    gamma = gamma[:D].contiguous()
    assert (x.data_ptr() % 16 != 0) == (case == "unaligned")
    got = rmsnorm.rmsnorm(x, gamma, kc.EPS)
    res = kc.compare(got, ref.rmsnorm(x, gamma, kc.EPS), kc.RMSNORM_TOL[dtype])
    assert res["ok"], res
    assert torch.equal(got, rmsnorm.rmsnorm(x, gamma, kc.EPS))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,dtype", kc.MATMUL_RAGGED, ids=str)
def test_matmul_kernel_ragged_edges(cuda, M, K, N, dtype):
    res = kc.check_matmul(M, K, N, dtype, cuda)
    assert res["ok"], res


# one shape of each kernel: decode with one slice and with many, wgmma
# unsplit and split, simt
VARIANT_SHAPES = [(4, 4096, 1024, torch.bfloat16), (8, 14336, 4096, torch.bfloat16),
                  (1, 64, 64, torch.bfloat16), (333, 4096, 14336, torch.bfloat16),
                  (128, 4096, 1024, torch.bfloat16), (9, 130, 33, torch.bfloat16),
                  (4, 4096, 1024, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,dtype", VARIANT_SHAPES, ids=str)
def test_matmul_kernel_gives_the_same_bits_every_call(cuda, M, K, N, dtype):
    """No float atomics: a second and third call (after another shape has
    used the decode workspace) give the bits of the first."""
    a, b = kc.matmul_inputs(M, K, N, dtype, cuda)
    first = matmul.matmul(a, b)
    again = matmul.matmul(a, b)
    matmul.matmul(*kc.matmul_inputs(2, 4096, 4096, torch.bfloat16, cuda, seed=3))
    third = matmul.matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, third)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,dtype", VARIANT_SHAPES, ids=str)
def test_matmul_kernel_one_launch_per_call(cuda, M, K, N, dtype):
    """Each variant is one launch a call: over 20 calls the profiler sees
    matmul kernels only, at most 20 (it may miss the first few), and the
    count adds 20."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    a, b = kc.matmul_inputs(M, K, N, dtype, cuda)
    matmul.matmul(a, b)                 # the decode workspace is made here
    torch.cuda.synchronize()
    launches.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            matmul.matmul(a, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert 1 <= len(names) <= 20 and all("matmul" in n for n in names), names
    assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES}, "matmul": 20}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_kernel_matches_plain(cuda, dtype):
    res = kc.check_paged_attention(dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", kc.PAGED_CASES, ids=lambda c: c[0])
def test_paged_attention_kernel_cases(cuda, case, dtype):
    """Split and unsplit launches (the traced decode step, slice edges and
    empty sequences, one sequence, a 128-row chunk on one table, the smoke
    heads, two row groups) match the plain version, and a second call gives
    the same bits."""
    res = kc.check_paged_case(case, dtype, cuda)
    assert res["ok"], res
    if case[0] == "chunk":
        assert res["plan"].splits == 1
    elif case[0] in ("decode", "B=1", "slice edges"):
        assert res["plan"].splits > 1


@pytest.mark.gpu
def test_paged_attention_second_stream_gets_its_own_workspace(cuda):
    """A split launch on another stream takes its own tickets and partials,
    gives the same bits, and leaves every ticket at zero."""
    args = kc.paged_inputs(torch.bfloat16, cuda, lens=kc.DECODE_LENS)
    first = paged_attention.paged_attention(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = paged_attention.paged_attention(*args)
    torch.cuda.synchronize()
    keys = [k for k in paged_attention._WORK if k[0] == torch.cuda.current_device()]
    assert len({k[1] for k in keys}) >= 2
    assert torch.equal(first, second)
    assert all(int(w[0].abs().sum()) == 0 for w in paged_attention._WORK.values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fr,fc,off", kc.CONV_FILTERS, ids=str)
def test_fconv2d_kernel_every_filter(cuda, fr, fc, off, dtype):
    """Every filter side 1..16, square (unrolled at 3, 5, 7) and not, over
    ragged outputs, from an aligned base and one element off it."""
    res = kc.check_fconv2d_filter(fr, fc, off, dtype, cuda)
    assert res["ok"], res
    assert res["plan"].variant == (fr if fr == fc and fr in (3, 5, 7) else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,window", kc.FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, B, S, window, dtype):
    res = kc.check_flash_attention(S, dtype, window, cuda, B=B)
    assert res["ok"], res
    assert res["variant"] == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")


@pytest.mark.gpu
@pytest.mark.parametrize("G,D,bt", [(1, 16, 8), (2, 16, 8), (4, 64, 32)])
def test_paged_attention_kernel_small_shapes(cuda, G, D, bt):
    """The smoke models' shapes: G 1 and 2, D 16, and a 32-token block."""
    args = kc.paged_inputs(torch.float32, cuda, lens=(0, 5, 8, 9, 40),
                           G=G, D=D, bt=bt, nblk=8, nb=30)
    res = kc.compare(paged_attention.paged_attention(*args),
                      kc.ref.paged_attention(*args), kc.ATTN_TOL[torch.float32])
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_kernel_head_dims(cuda, D, causal, dtype):
    res = kc.check_flash_head_dim(D, causal, dtype, cuda)
    assert res["ok"], res


# one shape of each flash kernel: wgmma at D = 128 (ragged S), 64 and 96
# (phi3-mini's heads), a B = 2 window case, tf32x3 in f32 (at 96 too), simt
# at head dims the tensor-core kernels do not take
FLASH_VARIANT_SHAPES = [(1, 32, 8, 223, 128, None, torch.bfloat16),
                        (2, 4, 2, 70, 64, 9, torch.bfloat16),
                        (1, 32, 8, 445, 128, 100, torch.bfloat16),
                        (1, 32, 8, 223, 128, None, torch.float32),
                        (2, 4, 2, 70, 32, 9, torch.bfloat16),
                        (1, 32, 32, 512, 96, None, torch.bfloat16),
                        (1, 32, 32, 512, 96, None, torch.float32)]


def _flash_case(B, Hq, Hkv, S, D, dtype, device):
    g = torch.Generator(device=device).manual_seed(2)
    return [torch.randn((B, S, h, D), generator=g, device=device).to(dtype)
            .transpose(1, 2) for h in (Hq, Hkv, Hkv)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", FLASH_VARIANT_SHAPES, ids=str)
def test_flash_attention_kernel_gives_the_same_bits_every_call(cuda, B, Hq, Hkv, S,
                                                                D, window, dtype):
    """No atomics: a second and a third call (after another shape) give the
    bits of the first."""
    q, k, v = _flash_case(B, Hq, Hkv, S, D, dtype, cuda)
    first = flash_attention.flash_attention(q, k, v, window=window)
    again = flash_attention.flash_attention(q, k, v, window=window)
    flash_attention.flash_attention(*_flash_case(1, 8, 2, 100, D, dtype, cuda))
    third = flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, third)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,dtype", FLASH_VARIANT_SHAPES, ids=str)
def test_flash_attention_kernel_one_launch_per_call(cuda, B, Hq, Hkv, S, D, window,
                                                    dtype):
    """Each variant is one launch a call: over 20 calls the profiler sees the
    variant's kernels only, at most 20 times each (tf32x3: its prologue
    that splits K and V, then its kernel), and the count adds 20."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _flash_case(B, Hq, Hkv, S, D, dtype, cuda)
    flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    launches.reset()
    kind = flash_attention.variant(S, S, D, dtype)
    tag = {"wgmma": "flash_wgmma_kernel", "simt": "flash_kernel",
           "tf32x3": "flash_tf32_"}[kind]
    kernels = 2 if kind == "tf32x3" else 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flash_attention.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert 1 <= len(names) <= 20 * kernels and all(tag in n for n in names), names
    assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES},
                                 "flash_attention": 20}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "paged_attention"])
def test_attention_kernels_refuse_what_they_do_not_take(cuda, kernel):
    """CPU tensors and float16 raise before anything launches (paged
    attention also refuses a call autograd would have to differentiate);
    flash attention differentiates instead, through its backward kernel."""
    launches.reset()
    if kernel == "flash_attention":
        q = torch.ones(1, 2, 4, 16, device=cuda)
        call = lambda *t: flash_attention.flash_attention(*t)
        args = (q, q, q)
    else:
        q = torch.ones(2, 1, 2, 16, device=cuda)
        pool = torch.zeros(1, 3, 8, 16, device=cuda)
        idx = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
        lens = torch.ones(2, dtype=torch.int32, device=cuda)
        call = lambda *t: paged_attention.paged_attention(*t)
        args = (q, pool, pool, idx, lens)
    with pytest.raises(ValueError, match="CUDA"):
        call(*[t.cpu() for t in args])
    with pytest.raises(TypeError):
        call(*[t.half() if t.is_floating_point() else t for t in args])
    if kernel == "paged_attention":
        with pytest.raises(RuntimeError, match="no backward"):
            call(q.clone().requires_grad_(), *args[1:])
    assert launches.LAUNCHES[kernel] == 0
    if kernel == "flash_attention":
        call(q.clone().requires_grad_(), q, q).sum().backward()
        torch.cuda.synchronize()
        assert launches.LAUNCHES[kernel] == launches.LAUNCHES[kernel + "_bwd"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["matmul", "rmsnorm", "flash_attention",
                                    "paged_attention"])
def test_launch_counted_only_where_a_kernel_launches(cuda, kernel):
    """An empty output launches nothing and leaves the count as it was; a
    call that launches adds exactly one."""
    launches.reset()
    if kernel == "matmul":
        empty = matmul.matmul(torch.ones(0, 8, device=cuda),
                              torch.ones(8, 4, device=cuda))
        assert empty.shape == (0, 4) and launches.LAUNCHES["matmul"] == 0
        assert matmul.matmul(torch.ones(3, 8, device=cuda),
                             torch.ones(8, 0, device=cuda)).shape == (3, 0)
        assert launches.LAUNCHES["matmul"] == 0
        ops.dense(torch.ones(2, 3, 8, device=cuda), torch.ones(8, 4, device=cuda))
    elif kernel == "rmsnorm":
        empty = rmsnorm.rmsnorm(torch.ones(0, 8, device=cuda),
                                torch.ones(8, device=cuda), 1e-6)
        assert empty.shape == (0, 8) and launches.LAUNCHES["rmsnorm"] == 0
        ops.rmsnorm(torch.ones(2, 3, 8, device=cuda), torch.ones(8, device=cuda))
    elif kernel == "flash_attention":
        z = torch.ones(1, 2, 0, 16, device=cuda)
        assert flash_attention.flash_attention(z, z, z).shape == (1, 2, 0, 16)
        assert launches.LAUNCHES[kernel] == 0
        q = torch.ones(1, 2, 5, 16, device=cuda)
        ops.attention(q, q[:, :1], q[:, :1], causal=True)
    else:
        pool = torch.zeros(1, 3, 8, 16, device=cuda)
        idx = torch.zeros(0, 2, dtype=torch.int32, device=cuda)
        empty = paged_attention.paged_attention(
            torch.ones(0, 1, 2, 16, device=cuda), pool, pool, idx,
            torch.ones(0, dtype=torch.int32, device=cuda))
        assert empty.shape == (0, 1, 2, 16) and launches.LAUNCHES[kernel] == 0
        out = ops.paged_attention(torch.ones(2, 1, 2, 16, device=cuda), pool,
                                  pool, idx.new_zeros(2, 2),
                                  torch.tensor([0, 3], dtype=torch.int32,
                                               device=cuda))
        assert bool((out == 0).all())       # lens 0, and a zero pool
    torch.cuda.synchronize()
    assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES}, kernel: 1}
    assert ops.LAUNCHES is launches.LAUNCHES


# -- the paper's Table I kernels ------------------------------------------------

RAGGED = [(k, c) for k, cases in kc.RAGGED.items() for c in cases]
CHECKS = {"jacobi": lambda c, dt, dev: kc.check_jacobi2d(*c, dt, dev),
          "conv": lambda c, dt, dev: kc.check_fconv2d(*c, dt, dev),
          "dot": lambda c, dt, dev: kc.check_dotprod(c, dt, dev),
          "expv": lambda c, dt, dev: kc.check_expv(c, dt, dev),
          "softmax": lambda c, dt, dev: kc.check_softmax_rows(*c, dt, dev),
          "softmax_masked": lambda c, dt, dev: kc.check_softmax_rows(
              *c, dt, dev, masked=True)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,case", RAGGED, ids=str)
def test_table1_kernel_matches_plain_at_ragged_shapes(cuda, kind, case, dtype):
    res = CHECKS[kind](case, dtype, cuda)
    assert res["ok"], res


# one shape of each softmax branch: rows in registers, aligned rows streamed
# twice, and rows that are not 16-byte aligned (plain loads)
SOFTMAX_BRANCH_SHAPES = [((64, 4096), "regs"), ((200, 40000), "stream"),
                         ((3, 300001), "stream")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("half_masked", [False, True])
@pytest.mark.parametrize("rw,branch", SOFTMAX_BRANCH_SHAPES, ids=str)
def test_softmax_rows_branches_match_plain_and_repeat(cuda, rw, branch, half_masked,
                                                      dtype):
    """Masked rows through each branch: within ``SOFTMAX_TOL`` of the plain
    version, masked elements exactly 0, the same bits on a second call.
    ``half_masked`` masks each row's first half too, so many threads hold
    no finite element."""
    x = kc.softmax_inputs(*rw, dtype, cuda, masked=True)
    if half_masked:
        x[:, :rw[1] // 2] = -float("inf")
    assert kc.softmax_branch(x) == branch
    got = reduction.softmax_rows(x)
    res = kc.compare(got, ref.softmax_rows(x), kc.SOFTMAX_TOL[dtype])
    assert res["ok"], res
    assert bool((got[torch.isneginf(x)] == 0).all())
    assert torch.equal(got, reduction.softmax_rows(x))


@pytest.mark.gpu
@pytest.mark.parametrize("hierarchy", kc.HIERARCHIES)
@pytest.mark.parametrize("n,C,L", [(4099, 16, 4), (5000, 3, 5), (70000, 8, 8)])
def test_dotprod_hier_kernel_matches_f64(cuda, n, C, L, hierarchy):
    res = kc.check_dotprod_hier(n, C, L, hierarchy, torch.float32, cuda)
    assert res["ok"], res


@pytest.mark.gpu
def test_dot_workspace_is_kept_and_left_zeroed(cuda):
    """One workspace a stream, allocated once: every launch leaves its
    tickets at zero, whatever its segments, so the next needs no fill."""
    a, b = kc.vec_inputs(70000, torch.float32, cuda)
    reduction.dotprod(a, b)
    idx = a.get_device()
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    work = reduction._DOT_WORK[key]
    assert work[1] == work[0].data_ptr()
    for C, L in ((16, 4), (3, 5), (1, 1)):
        reduction.dotprod_hier(a, b, C=C, L=L)
    reduction.dotprod(a[:4099], b[:4099])
    torch.cuda.synchronize()
    assert reduction._DOT_WORK[key] is work
    assert not work[0][:reduction.DOT_MAX_SEGS].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,C,L", [(16, 1, 1), (100, 1, 1), (4093, 1, 1),
                                   (4096, 1, 1), (4096, 16, 4), (5000, 3, 5)],
                         ids=str)
def test_one_block_dot_segments(cuda, n, C, L, dtype):
    """Segments of one block (every dotprod up to 4096 elements, and
    dotprod_hier's lanes at the paper's size) write their block's sum with
    no ticket: the same bits every call, also after other shapes, exact on
    {-1, 0, 1} inputs, and within the f64 bound at their chain."""
    if C * L == 1:
        seg, run = max(8, -(-n // 8) * 8), reduction.dotprod
        chain = kc.dot_chain(n)
    else:
        seg = reduction.lane_len(n, C, L)
        run = lambda a, b: reduction.dotprod_hier(a, b, C=C, L=L)
        chain = kc.hier_chain(n, C, L)
    assert reduction.dot_blocks(seg, C * L) == 1
    a, b = kc.vec_inputs(n, dtype, cuda)
    first = run(a, b)
    reduction.dotprod(*kc.vec_inputs(70000, dtype, cuda, seed=2))
    res = kc.compare_dot(first, run(a, b), a, b, chain)
    assert res["ok"], res
    sa, sb = kc.sign_inputs(n, dtype, cuda)
    assert run(sa, sb).item() == (sa.double() * sb.double()).sum().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_expv_kernel_equals_plain_at_the_round_half_edges(cuda, dtype):
    x = kc.expv_edge_inputs(cuda).to(dtype)
    res = kc.bit_diff(reduction.expv(x), ref.expv(x))
    assert res["ok"] and res["differ"] == 0, res


WRAPPER_CALLS = {
    "matmul": lambda t, d: matmul.matmul(t(2, 8), torch.ones(8, 8, device=d)),
    "rmsnorm": lambda t, d: rmsnorm.rmsnorm(t(2, 8), torch.ones(8, device=d), 1e-6),
    "flash_attention": lambda t, d: flash_attention.flash_attention(
        t(1, 2, 4, 16), torch.ones(1, 2, 4, 16, device=d),
        torch.ones(1, 2, 4, 16, device=d)),
    "paged_attention": lambda t, d: paged_attention.paged_attention(
        t(2, 1, 2, 16), torch.zeros(1, 3, 8, 16, device=d),
        torch.zeros(1, 3, 8, 16, device=d),
        torch.zeros(2, 2, dtype=torch.int32, device=d),
        torch.ones(2, dtype=torch.int32, device=d)),
    "dotprod": lambda t, d: reduction.dotprod(t(64), torch.ones(64, device=d)),
    "dotprod_hier": lambda t, d: reduction.lane_partials(
        t(64), torch.ones(64, device=d), C=2, L=2),
    "expv": lambda t, d: reduction.expv(t(64)),
    "softmax_rows": lambda t, d: reduction.softmax_rows(t(2, 8)),
    "jacobi2d": lambda t, d: stencil.jacobi2d(t(4, 4)),
    "fconv2d": lambda t, d: stencil.fconv2d(t(6, 6), torch.ones(3, 3, device=d)),
}


#: the wrappers with a backward kernel, and the plain version their
#: gradients are held against
DIFFERENTIABLE = {"matmul": lambda a, b: ref.matmul(a, b),
                  "rmsnorm": lambda x, g: ref.rmsnorm(x, g, 1e-6),
                  "flash_attention": lambda q, k, v: ref.attention(q, k, v)}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", list(WRAPPER_CALLS))
def test_every_kernel_refuses_a_call_autograd_would_differentiate(cuda, kernel):
    """A wrapper without a backward: a trainable CUDA input raises "no
    backward" and nothing launches; the same call under no_grad launches
    once.  A wrapper with one (rmsnorm, the matmul, flash attention)
    differentiates, and matches: one forward launch, one backward launch,
    and the gradient of the plain version (autograd of it, f32; rtol 1e-4,
    atol 1e-5 on unit-scale gradients of sums of at most 8 terms)."""
    counter = "dotprod" if kernel == "dotprod_hier" else kernel
    trainable = lambda *shape: torch.ones(*shape, device=cuda, requires_grad=True)
    launches.reset()
    if kernel in DIFFERENTIABLE:
        g = torch.Generator(device=cuda).manual_seed(0)
        made = []

        def drawn(*shape):
            made.append(torch.randn(*shape, generator=g, device=cuda).requires_grad_())
            return made[-1]
        out = WRAPPER_CALLS[kernel](drawn, cuda)
        w = torch.randn(out.shape, generator=g, device=cuda)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        # one backward launch: only the first input needs a gradient (the
        # matmul makes dA alone)
        assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES},
                                     counter: 1, counter + "_bwd": 1}
        x = made[0].detach().clone().requires_grad_()
        rest = {"matmul": [torch.ones(8, 8, device=cuda)],
                "rmsnorm": [torch.ones(8, device=cuda)],
                "flash_attention": [torch.ones(1, 2, 4, 16, device=cuda)] * 2}[kernel]
        (DIFFERENTIABLE[kernel](x, *rest) * w).sum().backward()
        res = kc.compare(made[0].grad, x.grad, (1e-4, 1e-5))
        assert res["ok"], res
        return
    with pytest.raises(RuntimeError, match="no backward"):
        WRAPPER_CALLS[kernel](trainable, cuda)
    assert not any(launches.LAUNCHES.values())
    with torch.no_grad():
        WRAPPER_CALLS[kernel](trainable, cuda)
    torch.cuda.synchronize()
    assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES}, counter: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["dotprod", "expv"])
def test_vector_kernels_take_unaligned_views(cuda, kernel):
    """A view one element in is not 16-byte aligned: the scalar loop."""
    a, b = kc.vec_inputs(4100, torch.float32, cuda)
    a, b = a[1:], b[1:]
    assert a.data_ptr() % 16
    if kernel == "dotprod":
        res = kc.compare_dot(reduction.dotprod(a, b), reduction.dotprod(a, b),
                             a, b, kc.dot_chain(a.numel()))
    else:
        x = 100 * a
        res = kc.compare_expv(reduction.expv(x), ref.expv(x))
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["dotprod", "dotprod_hier", "expv",
                                    "softmax_rows", "jacobi2d", "fconv2d"])
def test_table1_launches_per_call_and_never_the_plain_version(cuda, kernel,
                                                              monkeypatch):
    """Each call through ``ops`` launches exactly one kernel (dotprod_hier
    too: its C*L lanes are one launch) and never reaches ``ref``; an empty
    output launches nothing."""
    for name in ("dotprod", "lane_dots", "expv", "softmax_rows", "jacobi2d",
                 "fconv2d"):
        monkeypatch.setattr(ref, name, lambda *a, **k: pytest.fail("ref reached"))
    launches.reset()
    v = torch.ones(100, device=cuda)
    g = torch.ones(9, 11, device=cuda)
    call = {"dotprod": lambda: ops.dotprod(v, v),
            "dotprod_hier": lambda: ops.dotprod_hier(v, v, C=4, L=2),
            "expv": lambda: ops.expv(v),
            "softmax_rows": lambda: ops.softmax_rows(g),
            "jacobi2d": lambda: ops.jacobi2d(g),
            "fconv2d": lambda: ops.fconv2d(g, torch.ones(3, 3, device=cuda))}
    for i in range(3):
        call[kernel]()
        torch.cuda.synchronize()
        counter = "dotprod" if kernel == "dotprod_hier" else kernel
        assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES},
                                     counter: i + 1}
    empty = {"expv": lambda: reduction.expv(v[:0]),
             "softmax_rows": lambda: reduction.softmax_rows(g[:0]),
             "jacobi2d": lambda: stencil.jacobi2d(g[:, :0]),
             "fconv2d": lambda: stencil.fconv2d(g[:2], torch.ones(3, 3, device=cuda))}
    if kernel in empty:
        assert empty[kernel]().numel() == 0
        assert launches.LAUNCHES[kernel] == 3


@pytest.mark.gpu
def test_table1_kernels_refuse_what_they_do_not_take(cuda):
    launches.reset()
    v = torch.ones(16, device=cuda)
    g = torch.ones(8, 8, device=cuda)
    for call, args in ((reduction.dotprod, (v, v)), (reduction.expv, (v,)),
                       (reduction.softmax_rows, (g,)), (stencil.jacobi2d, (g,))):
        with pytest.raises(ValueError, match="CUDA"):
            call(*[t.cpu() for t in args])
        with pytest.raises(TypeError):
            call(*[t.half() for t in args])
    with pytest.raises(ValueError, match="taps"):
        stencil.fconv2d(torch.ones(40, 40, device=cuda), torch.ones(17, 3, device=cuda))
    with pytest.raises(ValueError, match="one length"):
        reduction.dotprod(v, v[:8])
    assert not any(launches.LAUNCHES[k] for k in
                   ("dotprod", "expv", "softmax_rows", "jacobi2d", "fconv2d"))


# -- the backward kernels (phase 3c) and the smoke train step (phase 4b) -------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,D", kc.RMSNORM_BWD_CASES
                         + ((kc.TRAIN_TOKENS, kc.PHI3_D_MODEL),))
def test_rmsnorm_backward_kernel_matches_plain(cuda, R, D, dtype):
    res = kc.check_rmsnorm_bwd(R, D, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mkn", [(kc.TRAIN_TOKENS, *kn) for kn in kc.MATMUL_KN.values()]
                         + list(kc.MATMUL_BWD_RAGGED)
                         + [(kc.TRAIN_TOKENS, *kn) for kn in kc.PHI3_MATMUL_KN.values()])
def test_matmul_backward_products_match_plain(cuda, mkn, dtype, which):
    res = kc.check_matmul_bwd(*mkn, dtype, which, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("mkn", [(kc.TRAIN_TOKENS, *kn) for kn in kc.MATMUL_KN.values()]
                         + list(kc.MATMUL_BWD_RAGGED)
                         + [(kc.TRAIN_TOKENS, *kn) for kn in kc.PHI3_MATMUL_KN.values()], ids=str)
def test_matmul_backward_products_one_launch_and_the_same_bits(cuda, mkn, which):
    """bf16 dX (``which`` "a") and dW ("b"): one launch a product, counted
    in ``matmul_bwd`` alone, and the same bits twice, and again after a
    product of another shape and plan has used the workspace."""
    M, K, N = mkn
    x, y = kc.matmul_bwd_inputs(M, K, N, torch.bfloat16, which, cuda)
    run = (lambda: matmul.grad_a(x, y)) if which == "a" else (lambda: matmul.grad_b(x, y))
    launches.reset()
    first = run()
    assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES}, "matmul_bwd": 1}
    again = run()
    matmul.grad_a(*kc.matmul_bwd_inputs(72, 1032, 4104, torch.bfloat16, "a", cuda, seed=3))
    third = run()
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, third)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_phi3_heads(cuda, dtype):
    """phi3-mini's 32 over 32 heads of 96 at a whole prompt, forward, and at
    the training length, backward: the wgmma kernels in bf16, the tf32x3
    ones in f32, within their limits, the same bits twice."""
    want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    res = kc.check_flash_phi3(kc.PHI3_FLASH_S, dtype, cuda)
    assert res["ok"] and res["variant"] == want, res
    B, S = kc.PHI3_FLASH_BWD
    res = kc.check_flash_bwd(B, S, dtype, None, True, kc.PHI3_HQ, kc.PHI3_HKV,
                             kc.PHI3_HEAD_DIM, cuda)
    assert res["ok"] and res["variant"] == want, res


@pytest.mark.gpu
@pytest.mark.parametrize("layout", kc.D96_LAYOUTS)
@pytest.mark.parametrize("B,S,Hq,Hkv,window", kc.D96_CASES, ids=str)
def test_flash_head_dim_96_on_wgmma_forward_and_backward(cuda, B, S, Hq, Hkv, window,
                                                         layout):
    """bf16 at D = 96: out, dq, dk, dv over every head within their limits,
    the same bits twice, and no store past column 96 (the NaN guard columns
    after each row intact)."""
    res = kc.check_flash_d96(B, S, Hq, Hkv, window, layout, cuda)
    assert res["variant"] == "wgmma" and res["guard_intact"], res
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("R,D", [(333, kc.D_MODEL), (4, 2 * kc.D_MODEL)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_backward_scalar_path_matches_the_vector_path(cuda, dtype, R, D):
    """The same rows through the scalar path (an unaligned view of them) and
    the vector path: both within the plain version's limit; rows of 8192
    f32 are wider than the vector path holds and take the scalar one."""
    x, gamma, dy = kc.rmsnorm_bwd_inputs(R, D, dtype, cuda)
    buf = torch.empty(R * D + 1, dtype=dtype, device=cuda)
    xu = buf[1:].view(R, D)
    xu.copy_(x)
    assert rmsnorm.bwd_path(D, dtype, aligned=False) == "scalar"
    want = ref.rmsnorm_bwd(dy, x, gamma, kc.EPS)
    tols = (kc.RMSNORM_BWD_TOL["dx"][dtype], kc.RMSNORM_BWD_TOL["dgamma"])
    for got in (rmsnorm.backward(dy, x, gamma, kc.EPS), rmsnorm.backward(dy, xu, gamma, kc.EPS)):
        for g, w, t in zip(got, want, tols):
            res = kc.compare(g, w, t)
            assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,window", kc.FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda, B, S, window, dtype):
    res = kc.check_flash_bwd(B, S, dtype, window, device=cuda)
    assert res["ok"], res
    assert res["variant"] == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")


@pytest.mark.gpu
def test_flash_backward_wgmma_at_the_training_length_d64(cuda):
    B, S, D = kc.FLASH_BWD_D64
    res = kc.check_flash_bwd(B, S, torch.bfloat16, None, True, kc.HQ, kc.HKV, D, cuda)
    assert res["ok"] and res["variant"] == "wgmma", res


@pytest.mark.gpu
@pytest.mark.parametrize("D", flash_attention.WGMMA_HEAD_DIMS)
def test_flash_backward_wgmma_reads_any_layout(cuda, D):
    """(B, H, S, D)-contiguous operands and the model's (B, S, H, D) views
    give the same bits: the kernels read both through their tensor maps."""
    q, k, v, do = kc.attention_bwd_inputs(2, 200, torch.bfloat16, 8, 2, D, cuda)
    views = flash_attention.backward(q, k, v, do, causal=True, window=77)
    dense = flash_attention.backward(*(t.contiguous() for t in (q, k, v, do)),
                                     causal=True, window=77)
    for a, b in zip(views, dense):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("D", flash_attention.WGMMA_HEAD_DIMS)
def test_flash_tf32x3_forward_and_backward_read_any_layout(cuda, D):
    """f32 on the TF32 tensor-core kernels: the model's (B, S, H, D) views
    and (B, H, S, D)-contiguous operands give the same bits, forward and
    backward, within the limits; a ragged prompt, a window across tiles,
    GQA 8/2."""
    q, k, v, do = kc.attention_bwd_inputs(2, 200, torch.float32, 8, 2, D, cuda)
    assert flash_attention.variant(200, 200, D, torch.float32) == "tf32x3"
    assert flash_attention.bwd_variant(200, 200, D, torch.float32) == "tf32x3"
    dense = [t.contiguous() for t in (q, k, v, do)]
    outs = [flash_attention.flash_attention(*ts[:3], causal=True, window=77)
            for ts in ((q, k, v), dense)]
    grads = [flash_attention.backward(*ts, causal=True, window=77) for ts in ((q, k, v, do),
                                                                              dense)]
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    want = ref.attention(q, k, v, causal=True, window=77)
    res = kc.compare(outs[0], want, kc.ATTN_TOL[torch.float32])
    assert res["ok"], res
    for g, w in zip(grads[0], ref.attention_bwd(q, k, v, do, causal=True, window=77)):
        res = kc.compare(g, w, kc.ATTN_BWD_TOL[torch.float32])
        assert res["ok"], res


@pytest.mark.gpu
def test_flash_tf32x3_at_the_kernel_table_rows(cuda):
    """Row 3b's forward (1, 32/8, 512, 128) and row 3h's backward (4,
    32/8, 1024, 128), causal f32, on the TF32 kernels: within the limits,
    the same bits twice."""
    res = kc.check_flash_attention(512, torch.float32, None, cuda)
    assert res["ok"] and res["variant"] == "tf32x3", res
    B, S, _ = kc.FLASH_BWD_CASES[0]
    res = kc.check_flash_bwd(B, S, torch.float32, None, device=cuda)
    assert res["ok"] and res["variant"] == "tf32x3", res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_backward_kernel_head_dims(cuda, D, causal, dtype):
    """Two sequences of 70 over 4 q and 2 kv heads, window 9."""
    res = kc.check_flash_bwd(2, 70, dtype, 9, causal, 4, 2, D, cuda)
    assert res["ok"], res


@pytest.mark.gpu
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.testing import train_checks as tc
    res = tc.compare_runs(tc.run_smoke(cuda), tc.run_smoke("cpu"))
    assert res["ok"], res


# -- the MoE training and Mamba2 paths' shapes (chip_smoke.py phases 3, 3c,
# 4b, 8 and 9) ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "mamba2-370m", "jamba-1.5-large-398b"])
def test_family_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """The MoE and Mamba smoke models' loss, gradients and two steps from the
    JAX init, card against CPU, at ``train_checks``' limits (jamba held at
    its start)."""
    from repro_torch.testing import train_checks as tc
    res = tc.compare_runs(tc.run_smoke(cuda, arch=arch), tc.run_smoke("cpu", arch=arch),
                          arch=arch)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", kc.MAMBA_ROWS)
@pytest.mark.parametrize("proj", list(kc.MAMBA_MATMUL_KN))
def test_matmul_kernel_mamba_projections(cuda, proj, M, dtype):
    """mamba2-370m's in_proj (N = 4,384: its 32-column edge tile read alone
    too) and out_proj (K = 2,048) at a decode step's, a prefill's and a train
    step's rows: within the limit, the same bits twice."""
    K, N = kc.MAMBA_MATMUL_KN[proj]
    res = kc.check_matmul(M, K, N, dtype, cuda)
    assert res["ok"], res
    assert (res["edge"]["ok"], N % 128) == (True, 32 if proj == "in_proj" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("proj", list(kc.MAMBA_MATMUL_KN))
def test_matmul_backward_mamba_projections(cuda, proj, dtype, which):
    K, N = kc.MAMBA_MATMUL_KN[proj]
    res = kc.check_matmul_bwd(kc.TRAIN_TOKENS, K, N, dtype, which, cuda)
    assert res["ok"], res
    assert res["variant"] == ("wgmma" if dtype == torch.bfloat16 else "simt")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", kc.MAMBA_ROWS)
@pytest.mark.parametrize("D", kc.MAMBA_NORM_D)
def test_rmsnorm_kernel_mamba_widths(cuda, D, R, dtype):
    res = kc.check_rmsnorm(R, D, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", kc.MAMBA_NORM_D)
def test_rmsnorm_backward_mamba_widths(cuda, D, dtype):
    res = kc.check_rmsnorm_bwd(kc.TRAIN_TOKENS, D, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("proj", list(kc.MOE_KN))
@pytest.mark.parametrize("C", kc.MOE_TRAIN_C)
def test_matmul_expert_products_at_the_train_steps_rows(cuda, C, proj, dtype):
    """mixtral-8x7b's expert products at C buffer rows, forward, dX and dW
    (dW contracts over C: simt where C is not a multiple of 8)."""
    K, N = kc.MOE_KN[proj]
    assert kc.check_matmul(C, K, N, dtype, cuda)["ok"]
    for which in "ab":
        res = kc.check_matmul_bwd(C, K, N, dtype, which, cuda)
        assert res["ok"], (which, res)
        if which == "b" and dtype == torch.bfloat16:
            assert res["variant"] == ("wgmma" if C % 8 == 0 else "simt")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_at_mixtrals_train_shape(cuda, dtype):
    """(4, 32/8, 1024, 128) with the 4,096-token window, forward and
    backward: bf16 on wgmma, f32 on tf32x3."""
    B, S, window = kc.MIXTRAL_TRAIN_FLASH
    fwd = kc.check_flash_attention(S, dtype, window, cuda, B=B)
    bwd = kc.check_flash_bwd(B, S, dtype, window, device=cuda)
    assert fwd["ok"] and bwd["ok"], (fwd, bwd)
    assert bwd["variant"] == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")


# -- the cross-attention families (chip_smoke.py phases 3, 3c and 10) ----------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [c[0] for c in kc.XATTN_FLASH_CASES])
def test_flash_attention_cross_forward_and_backward(cuda, case, dtype):
    """Non-causal, no window, Sk != S (and the encoder's S = Sk): out, dq,
    dk, dv within their limits, the same bits twice; bf16 at head dims 64
    and 128 on the wgmma forward and the tensor-core backward (stats over
    vlm's 6,404 image tokens, with the forward's statistics held too; wgmma
    below ``STATS_MIN_SK`` keys), f32 there on tf32x3, the rest simt."""
    _, B, S, Sk, Hq, Hkv, D = next(c for c in kc.XATTN_FLASH_CASES if c[0] == case)
    res = kc.check_flash_cross(B, S, Sk, Hq, Hkv, D, dtype, cuda)
    assert res["ok"], res
    want = ((("wgmma" if dtype == torch.bfloat16 else "tf32x3")
             if D in flash_attention.WGMMA_HEAD_DIMS else "simt"))
    want_bwd = "stats" if want == "wgmma" and Sk >= flash_attention.STATS_MIN_SK else want
    assert (res["variant"], res["bwd_variant"]) == (want, want_bwd)
    assert ("stats" in res["parts"]) == (want_bwd == "stats")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [c[0] for c in kc.STATS_FLASH_CASES])
def test_flash_stats_backward_forced_matches_plain(cuda, case):
    """The stats backward (and the forward's statistics) where the rule
    does not give it: causal, windowed, every head dim, both training
    shapes; within their limits, the same bits twice."""
    _, B, S, Sk, Hq, Hkv, D, causal, window = next(
        c for c in kc.STATS_FLASH_CASES if c[0] == case)
    res = kc.check_flash_stats_bwd(B, S, Sk, Hq, Hkv, D, causal, window, cuda)
    assert res["ok"] and "stats" in res["parts"], res


@pytest.mark.gpu
def test_flash_stats_under_autograd_and_serving_writes_none(cuda):
    """Autograd's forward of a stats call writes L and the f32 output (one
    launch) and its backward reads them (one launch, no forward); the same
    call without autograd writes neither and launches once."""
    q, k, v, do = kc.cross_inputs(1, 64, 2048, 4, 1, 128, torch.bfloat16, cuda)
    assert flash_attention.bwd_variant(64, 2048, 128, torch.bfloat16) == "stats"
    launches.reset()
    with torch.no_grad():
        flash_attention.flash_attention(q, k, v, causal=False)
    assert launches.LAUNCHES["flash_attention"] == 1
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = flash_attention.flash_attention(qg, kg, vg, causal=False)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[3].shape == (1, 4, 64) and saved[4].dtype == torch.float32
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert launches.LAUNCHES["flash_attention"] == 2
    assert launches.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.attention_bwd(q, k, v, do, causal=False)
    for g, w in zip(grads, want):
        assert kc.compare(g, w, kc.ATTN_BWD_TOL[torch.bfloat16])["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", kc.XATTN_MATMUL, ids=lambda s: f"{s[0]}-M{s[1]}")
def test_matmul_kernel_cross_attention_families(cuda, shape, dtype):
    _, M, K, N = shape
    res = kc.check_matmul(M, K, N, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["a", "b"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", kc.XATTN_MATMUL_BWD, ids=lambda s: s[0])
def test_matmul_backward_cross_attention_families(cuda, shape, dtype, which):
    _, M, K, N = shape
    res = kc.check_matmul_bwd(M, K, N, dtype, which, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R, D", kc.XATTN_NORM)
def test_rmsnorm_kernel_seamless_width(cuda, R, D, dtype):
    res = kc.check_rmsnorm(R, D, dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llama-3.2-vision-11b"])
def test_cross_attention_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Phase 4b's check for the cross-attention archs: the loss, every
    gradient leaf and two steps from the JAX init, their contexts drawn as
    the launcher draws them."""
    from repro_torch.testing import train_checks as tc
    res = tc.compare_runs(tc.run_smoke(cuda, steps=2, arch=arch),
                          tc.run_smoke("cpu", steps=2, arch=arch), arch=arch)
    assert res["ok"], res


def _leaf_bytes(d):
    return {f.name: f.read_bytes() for f in sorted(d.glob("leaf_*.npy"))}


@pytest.mark.gpu
def test_resumed_run_on_the_card_equals_an_uninterrupted_one(cuda, tmp_path):
    """The smoke model on the card: 6 steps with a checkpoint every 2, then
    a run resumed from the step-2 checkpoint alone gives steps 2-5's
    losses bit for bit and writes steps 4 and 6 with the same bytes."""
    import shutil

    from repro_torch.launch.train import run

    kw = dict(steps=6, global_batch=4, seq_len=32, ckpt_every=2, device=cuda,
              log_every=100)
    whole = run("llama3-8b", ckpt_dir=str(tmp_path / "whole"), **kw)
    shutil.copytree(tmp_path / "whole" / "step_00000002",
                    tmp_path / "resumed" / "step_00000002")
    resumed = run("llama3-8b", ckpt_dir=str(tmp_path / "resumed"), **kw)
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    for step in ("step_00000004", "step_00000006"):
        assert _leaf_bytes(tmp_path / "resumed" / step) == \
            _leaf_bytes(tmp_path / "whole" / step)


@pytest.mark.gpu
def test_save_async_on_the_card_keeps_the_state_of_its_step(cuda, tmp_path):
    """``save_async`` then an in-place train step on the card before
    ``wait()``: the checkpoint holds the state as it was at the save."""
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.testing import train_checks as tc
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import init_train_state

    cfg = get_smoke_config("llama3-8b")
    opt_cfg = tc.opt_config(2)
    state = init_train_state(cfg, opt_cfg, torch.Generator(cuda).manual_seed(0), cuda)
    tokens = torch.from_numpy(tc.smoke_batches(1)[0]).to(cuda, torch.int64)
    before = [t.detach().cpu().clone() for t in flatten(state)]
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(state, 1)
    state, _ = make_train_step(cfg, opt_cfg)(state, {"tokens": tokens})
    torch.cuda.synchronize()
    mgr.wait()
    got, step, _ = restore_checkpoint(tmp_path, state, device="cpu")
    assert step == 1
    after = flatten(state)
    assert not all(torch.equal(a.cpu(), b) for a, b in zip(after, before))
    for g, b in zip(flatten(got), before):
        assert g.dtype == b.dtype and torch.equal(g, b)
