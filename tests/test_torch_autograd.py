"""Autograd through the port's kernel seam on the CPU.

rmsnorm, the matmul and flash attention have backward kernels: their
wrappers differentiate (``autograd.Function``s whose backward is the kernel
on the card and the plain backward formula on the CPU), so a trainable
input reaches the device check and nothing launches here; the Functions
themselves, on CPU tensors, give ``jax.grad``'s gradients.  Every other
kernel wrapper refuses a call that autograd would have to differentiate,
before it checks the device, and launches nothing.  The CPU path (the
plain versions) differentiates as the reference's jnp path does: its
gradients are held against ``jax.grad`` of ``repro.kernels.ops``
(``use_pallas=False``) on the same numpy inputs.

Tolerance: rtol 1e-4, atol 1e-5.  Both sides compute in f32 with sums in
different orders (a few ulp on these unit-scale gradients); expv's
gradient is the derivative of the TPU kernel's degree-6 polynomial on one
side and jnp.exp on the other, which differ by ~3e-6 of the value
(r**6 / 720 at |r| <= ln2 / 2).  A gradient that drops a term or lands
on the wrong input is off by far more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import (flash_attention, launches, matmul, ops,
                                 paged_attention, reduction, rmsnorm, stencil)
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

TOL = dict(rtol=1e-4, atol=1e-5)


def _paged_args(trainable: bool):
    """q (2, 1, 2, 16), pools (1, 3, 8, 16), tables, lens."""
    q = torch.ones(2, 1, 2, 16, requires_grad=trainable)
    pool = torch.zeros(1, 3, 8, 16)
    return (q, pool, pool, torch.zeros(2, 2, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32))


# each kernel wrapper called on CPU tensors, its first float input
# trainable or not
WRAPPERS = {
    "matmul": lambda g: matmul.matmul(torch.ones(2, 3, requires_grad=g),
                                      torch.ones(3, 4)),
    "rmsnorm": lambda g: rmsnorm.rmsnorm(torch.ones(2, 8), torch.ones(8, requires_grad=g),
                                         1e-6),
    "rmsnorm_x": lambda g: rmsnorm.rmsnorm(torch.ones(2, 8, requires_grad=g), torch.ones(8),
                                           1e-6),
    "flash_attention": lambda g: flash_attention.flash_attention(
        torch.ones(1, 2, 3, 16, requires_grad=g), torch.ones(1, 2, 3, 16),
        torch.ones(1, 2, 3, 16)),
    "paged_attention": lambda g: paged_attention.paged_attention(*_paged_args(g)),
    "dotprod": lambda g: reduction.dotprod(torch.ones(8), torch.ones(8, requires_grad=g)),
    "dotprod_hier": lambda g: reduction.lane_partials(torch.ones(8, requires_grad=g),
                                                      torch.ones(8), C=2, L=2),
    "expv": lambda g: reduction.expv(torch.ones(8, requires_grad=g)),
    "softmax_rows": lambda g: reduction.softmax_rows(torch.ones(2, 8, requires_grad=g)),
    "jacobi2d": lambda g: stencil.jacobi2d(torch.ones(4, 4, requires_grad=g)),
    "fconv2d": lambda g: stencil.fconv2d(torch.ones(6, 6),
                                         torch.ones(3, 3, requires_grad=g)),
}


# the wrappers with a backward kernel: each one's autograd.Function, and
# the reference op whose jax.grad it must give, on small CPU inputs
DIFFERENTIATE = {
    "matmul": (lambda r: [_draw(r, 5, 12), _draw(r, 12, 7)],
               matmul.Matmul.apply,
               lambda a, b: jops.matmul(a, b, use_pallas=False)),
    "rmsnorm": (lambda r: [_draw(r, 3, 32), _draw(r, 32)],
                lambda x, g: rmsnorm.RMSNorm.apply(x, g, 1e-6),
                lambda x, g: jops.rmsnorm(x, g, eps=1e-6, use_pallas=False)),
    "rmsnorm_x": (lambda r: [_draw(r, 2, 3, 16), _draw(r, 16)],
                  lambda x, g: rmsnorm.RMSNorm.apply(x, g, 1e-5),
                  lambda x, g: jops.rmsnorm(x, g, eps=1e-5, use_pallas=False)),
    "flash_attention": (
        lambda r: [_draw(r, 2, 4, 11, 16), _draw(r, 2, 2, 11, 16),
                   _draw(r, 2, 2, 11, 16)],
        lambda q, k, v: flash_attention.FlashAttention.apply(q, k, v, True, 4),
        lambda q, k, v: jops.attention(q, k, v, causal=True, window=4,
                                       use_pallas=False)),
}


def _grads_match(port, jax_op, floats, seed):
    """d/d(inputs) of sum(op(inputs) * w), the port's through torch autograd
    and the reference's through jax.grad, within TOL."""
    w = np.random.default_rng(seed).normal(
        size=np.shape(jax_op(*floats))).astype(np.float32)
    ts = [torch.tensor(x, requires_grad=True) for x in floats]
    (port(*ts) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda *fs: jnp.sum(jax_op(*fs) * w),
                    argnums=tuple(range(len(floats))))(*floats)
    for t, g in zip(ts, want):
        assert t.grad is not None and t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_kernel_wrappers_refuse_autograd_before_the_device_check(kernel):
    """A wrapper without a backward: a trainable input raises "no backward"
    before anything else is checked (these are CPU tensors, which the
    kernels never take), and nothing launches; the same call under no_grad
    reaches the device check.  A wrapper with a backward kernel (rmsnorm,
    the matmul, flash attention) differentiates, and matches: a trainable
    input reaches the device check, nothing launches, and its Function on
    CPU tensors gives jax.grad's gradients."""
    launches.reset()
    if kernel in DIFFERENTIATE:
        with pytest.raises(ValueError, match="CUDA"):
            WRAPPERS[kernel](True)
        make, port, jax_op = DIFFERENTIATE[kernel]
        _grads_match(port, jax_op, make(np.random.default_rng(7)), len(kernel))
        assert not any(launches.LAUNCHES.values())
        return
    with pytest.raises(RuntimeError, match="no backward"):
        WRAPPERS[kernel](True)
    assert not any(launches.LAUNCHES.values())
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        WRAPPERS[kernel](True)
    with pytest.raises(ValueError, match="CUDA"):
        WRAPPERS[kernel](False)
    assert not any(launches.LAUNCHES.values())


def _draw(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _paged_case(rng):
    q = _draw(rng, 3, 2, 2, 16)
    kpool, vpool = _draw(rng, 2, 6, 4, 16), _draw(rng, 2, 6, 4, 16)
    tables = np.array([[1, 2, 3], [4, 5, 0], [2, 1, 0]], np.int32)
    lens = np.array([11, 5, 0], np.int32)
    return [q, kpool, vpool], [tables, lens]


# (float inputs, int inputs, the port's op, the reference's op); the
# float inputs are the ones differentiated
CASES = {
    "rmsnorm": (lambda r: ([_draw(r, 3, 32), _draw(r, 32)], []),
                lambda x, g: ops.rmsnorm(x, g, 1e-5),
                lambda x, g: jops.rmsnorm(x, g, eps=1e-5, use_pallas=False)),
    "matmul": (lambda r: ([_draw(r, 5, 12), _draw(r, 12, 7)], []),
               ops.matmul, lambda a, b: jops.matmul(a, b, use_pallas=False)),
    "dense": (lambda r: ([_draw(r, 2, 3, 12), _draw(r, 12, 7)], []),
              ops.dense, lambda x, w: jops.dense(x, w, use_pallas=False)),
    "attention": (lambda r: ([_draw(r, 1, 4, 9, 16), _draw(r, 1, 2, 9, 16),
                              _draw(r, 1, 2, 9, 16)], []),
                  lambda q, k, v: ops.attention(q, k, v, causal=True, window=5),
                  lambda q, k, v: jops.attention(q, k, v, causal=True, window=5,
                                                 use_pallas=False)),
    "paged_attention": (_paged_case, ops.paged_attention,
                        lambda *a: jops.paged_attention(*a, use_pallas=False)),
    "jacobi2d": (lambda r: ([_draw(r, 6, 9)], []), ops.jacobi2d,
                 lambda x: jops.jacobi2d(x, use_pallas=False)),
    "fconv2d": (lambda r: ([_draw(r, 8, 11), _draw(r, 3, 3)], []), ops.fconv2d,
                lambda x, f: jops.fconv2d(x, f, use_pallas=False)),
    "dotprod": (lambda r: ([_draw(r, 37), _draw(r, 37)], []), ops.dotprod,
                lambda a, b: jops.dotprod(a, b, use_pallas=False)),
    "dotprod_hier": (lambda r: ([_draw(r, 37), _draw(r, 37)], []),
                     lambda a, b: ops.dotprod_hier(a, b, C=2, L=2),
                     lambda a, b: jops.dotprod_hier(a, b, C=2, L=2,
                                                    use_pallas=False)),
    "expv": (lambda r: ([_draw(r, 64, scale=4.0)], []), ops.expv,
             lambda x: jops.expv(x, use_pallas=False)),
    "softmax_rows": (lambda r: ([_draw(r, 3, 10, scale=3.0)], []), ops.softmax_rows,
                     lambda x: jops.softmax_rows(x, use_pallas=False)),
}


@pytest.mark.parametrize("op", list(CASES))
def test_cpu_seam_differentiates_as_the_reference(op):
    """d/d(inputs) of sum(op(inputs) * w), w drawn once: the port's plain
    path through torch autograd against jax.grad of the reference."""
    make, port, jax_op = CASES[op]
    rng = np.random.default_rng(len(op))
    floats, ints = make(rng)
    w = rng.normal(size=np.shape(jax_op(*floats, *ints))).astype(np.float32)
    ts = [torch.tensor(x, requires_grad=True) for x in floats]
    out = port(*ts, *[torch.from_numpy(i) for i in ints])
    (out * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda *fs: jnp.sum(jax_op(*fs, *ints) * w),
                    argnums=tuple(range(len(floats))))(*floats)
    for t, g in zip(ts, want):
        assert t.grad is not None and t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)
