"""The port's one wall-clock read (lint rule L4 allows it here only).

Intervals on the host's clock; around work on the card, synchronise first
(``torch.cuda.synchronize()``), since PyTorch returns before the device
finishes."""
from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds, for intervals."""
    return time.perf_counter()  # repro: noqa(L4)
