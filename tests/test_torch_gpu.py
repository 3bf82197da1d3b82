"""The port's kernels against their plain versions on the card, at the
llama3-8b serving shapes (the checks of ``chip_smoke.py``'s kernel phase),
their launch counts, and what their wrappers refuse.

Marked ``gpu``: they skip where there is no CUDA card.  Run them on the
machine with the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import pytest
import torch

from repro_torch.kernels import (flash_attention, launches, matmul, ops,
                                 paged_attention, rmsnorm)
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
