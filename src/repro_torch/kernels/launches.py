"""Launch counters of the port's kernels.

Each kernel wrapper adds one to its count on the line that launches its
kernel, and nowhere else: a call that returns without launching (an empty
output) leaves the count as it was.  A run resets the counts before the
path it wants to account for and reads them after it, to show that the
path went through the kernels."""
from __future__ import annotations

LAUNCHES = {"rmsnorm": 0, "matmul": 0, "flash_attention": 0,
            "paged_attention": 0}


def reset() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
