"""The port's kernels against their plain versions on the card, at the
llama3-8b serving shapes and at the paper's Table I shapes (the checks of
``chip_smoke.py``'s kernel phases), their launch counts, and what their
wrappers refuse.

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
@pytest.mark.parametrize("R", kc.RMSNORM_R)
def test_rmsnorm_kernel_matches_plain(cuda, R, dtype):
    res = kc.check_rmsnorm(R, kc.D_MODEL, dtype, cuda)
    assert res["ok"], res


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
@pytest.mark.parametrize("B,S,window", kc.FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, B, S, window, dtype):
    res = kc.check_flash_attention(S, dtype, window, cuda, B=B)
    assert res["ok"], res
    assert res["variant"] == ("wgmma" if dtype == torch.bfloat16 else "simt")


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


# one shape of each flash kernel: wgmma at D = 128 (ragged S) and 64, a B = 2
# window case, simt in f32 and at a head dim wgmma does not take
FLASH_VARIANT_SHAPES = [(1, 32, 8, 223, 128, None, torch.bfloat16),
                        (2, 4, 2, 70, 64, 9, torch.bfloat16),
                        (1, 32, 8, 445, 128, 100, torch.bfloat16),
                        (1, 32, 8, 223, 128, None, torch.float32),
                        (2, 4, 2, 70, 32, 9, torch.bfloat16)]


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
    variant's kernel only, at most 20 times, and the count adds 20."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _flash_case(B, Hq, Hkv, S, D, dtype, cuda)
    flash_attention.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    launches.reset()
    tag = {"wgmma": "flash_wgmma_kernel", "simt": "flash_kernel"}[
        flash_attention.variant(S, S, D, dtype)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flash_attention.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert 1 <= len(names) <= 20 and all(tag in n for n in names), names
    assert launches.LAUNCHES == {**{k: 0 for k in launches.LAUNCHES},
                                 "flash_attention": 20}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flash_attention", "paged_attention"])
def test_attention_kernels_refuse_what_they_do_not_take(cuda, kernel):
    """CPU tensors, float16, and (flash) a call autograd would have to
    differentiate all raise before anything launches."""
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
    if kernel == "flash_attention":
        with pytest.raises(RuntimeError, match="no backward"):
            call(q.clone().requires_grad_(), q, q)
    assert launches.LAUNCHES[kernel] == 0


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


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", list(WRAPPER_CALLS))
def test_every_kernel_refuses_a_call_autograd_would_differentiate(cuda, kernel):
    """A trainable CUDA input raises "no backward" and nothing launches; the
    same call under no_grad launches once."""
    counter = "dotprod" if kernel == "dotprod_hier" else kernel
    trainable = lambda *shape: torch.ones(*shape, device=cuda, requires_grad=True)
    launches.reset()
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
