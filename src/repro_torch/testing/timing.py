"""The port's wall-clock reads (lint rule L4 allows them here only).

:func:`now` measures intervals on the host's clock; around work on the
card, synchronise first (``torch.cuda.synchronize()``), since PyTorch
returns before the device finishes.  :func:`monotonic` is the
liveness-deadline clock of the multi-process chaos supervisor
(``repro_torch.ft.cluster``)."""
from __future__ import annotations

import time


def now() -> float:
    """Monotonic seconds, for intervals."""
    return time.perf_counter()  # repro: noqa(L4)


def monotonic() -> float:
    """Real monotonic seconds: the *liveness-deadline* clock.

    The second (and last) sanctioned raw clock read.  :func:`now` serves
    interval measurement; this one serves deadlines against the outside
    world: the multi-process chaos supervisor must decide that a worker
    whose socket heartbeats stopped is dead, which is only meaningful on a
    clock that keeps ticking while this process sleeps.  ``time.monotonic``
    never jumps under NTP slew and is system-wide, so two processes'
    deadlines compose.  The virtual clock (``ft.chaos.VirtualClock``) stays
    virtual; nothing outside supervisor liveness code reads this one."""
    return time.monotonic()  # repro: noqa(L4)
