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
@pytest.mark.parametrize("mkn", [(1, 1, 1), (8, 130, 33), (9, 130, 33),
                                 (17, 33, 65), (3, 0, 5)])
def test_matmul_kernel_ragged_edges(cuda, mkn):
    res = kc.check_matmul(*mkn, torch.float32, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_attention_kernel_matches_plain(cuda, dtype):
    res = kc.check_paged_attention(dtype, cuda)
    assert res["ok"], res


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,window", [(S, None) for S in kc.FLASH_S]
                         + [kc.FLASH_WINDOW])
def test_flash_attention_kernel_matches_plain(cuda, S, window, dtype):
    res = kc.check_flash_attention(S, dtype, window, cuda)
    assert res["ok"], res


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
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_flash_attention_kernel_head_dims(cuda, D, causal):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 70, h, D), generator=g, device=cuda)
               .transpose(1, 2) for h in (4, 2, 2))
    got = flash_attention.flash_attention(q, k, v, causal=causal, window=9)
    want = kc.ref.attention(q, k, v, causal=causal, window=9)
    res = kc.compare(got, want, kc.ATTN_TOL[torch.float32])
    assert res["ok"], res


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
    key = (a.device, torch.cuda.current_stream(a.device).cuda_stream)
    work = reduction._DOT_WORK[key]
    for C, L in ((16, 4), (3, 5), (1, 1)):
        reduction.dotprod_hier(a, b, C=C, L=L)
    reduction.dotprod(a[:4099], b[:4099])
    torch.cuda.synchronize()
    assert reduction._DOT_WORK[key] is work
    assert not work[:reduction.DOT_MAX_SEGS].any()


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
