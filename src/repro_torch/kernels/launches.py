"""Launch counters of the port's kernels, the test for a call that autograd
will differentiate, and the refusal of the wrappers that have no backward.

Each kernel wrapper adds one to its count on the line that launches its
kernel, and nowhere else: a call that returns without launching (an empty
output) leaves the count as it was.  A run resets the counts before the
path it wants to account for and reads them after it, to show that the
path went through the kernels."""
from __future__ import annotations

import torch

LAUNCHES = {"rmsnorm": 0, "matmul": 0, "flash_attention": 0,
            "paged_attention": 0, "dotprod": 0, "expv": 0, "softmax_rows": 0,
            "jacobi2d": 0, "fconv2d": 0,
            # the backward kernels: rmsnorm's dx and dgamma (one call), each
            # of the matmul's two products (dA and dB apart), flash
            # attention's dq, dk and dv (one call)
            "rmsnorm_bwd": 0, "matmul_bwd": 0, "flash_attention_bwd": 0}


#: the devices whose tensors take a kernel's plain version: the CPU, and
#: ``meta`` (shapes without data: the dry run, ``launch.dryrun``, counts a
#: cell's operations on it).  A CUDA tensor takes the kernel or the call
#: raises
PLAIN_DEVICES = ("cpu", "meta")


def plain(t: torch.Tensor) -> bool:
    """True where ``t`` takes the plain version (:data:`PLAIN_DEVICES`)."""
    return t.device.type in PLAIN_DEVICES


def reset() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def wants_grad(*ts: torch.Tensor) -> bool:
    """True where autograd records the call: grad mode on and an input
    that needs a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def refuse_autograd(name: str, *ts: torch.Tensor) -> None:
    """Raise where autograd would have to differentiate the kernel's call:
    a kernel fills a fresh tensor, which has no ``grad_fn``, so a trainable
    input would get no gradient.  rmsnorm, the matmul and flash attention
    have backward kernels (their wrappers are ``autograd.Function``s); the
    others have none, and their plain versions (the CPU path)
    differentiate."""
    if wants_grad(*ts):
        raise RuntimeError(f"{name} kernel has no backward yet: call it under "
                           f"torch.no_grad() or on inputs that need no gradient")
