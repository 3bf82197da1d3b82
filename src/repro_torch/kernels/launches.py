"""Launch counters of the port's kernels, and the refusal every kernel
wrapper makes before it checks or launches anything.

Each kernel wrapper adds one to its count on the line that launches its
kernel, and nowhere else: a call that returns without launching (an empty
output) leaves the count as it was.  A run resets the counts before the
path it wants to account for and reads them after it, to show that the
path went through the kernels."""
from __future__ import annotations

import torch

LAUNCHES = {"rmsnorm": 0, "matmul": 0, "flash_attention": 0,
            "paged_attention": 0, "dotprod": 0, "expv": 0, "softmax_rows": 0,
            "jacobi2d": 0, "fconv2d": 0}


def reset() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def refuse_autograd(name: str, *ts: torch.Tensor) -> None:
    """Raise where autograd would have to differentiate the kernel's call:
    a kernel fills a fresh tensor, which has no ``grad_fn``, so a trainable
    input would get no gradient.  No kernel has a backward yet; the plain
    versions (the CPU path) differentiate."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} kernel has no backward yet: call it under "
                           f"torch.no_grad() or on inputs that need no gradient")
