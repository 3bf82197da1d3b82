"""The port's wall-clock reads (lint rule L4 allows them here only).

:func:`now` measures intervals on the host's clock; around work on the
card, synchronise first (``torch.cuda.synchronize()``), since PyTorch
returns before the device finishes.  :func:`monotonic` is the
liveness-deadline clock of the multi-process chaos supervisor
(``repro_torch.ft.cluster``).  :func:`measure_us` (and its float façade
:func:`median_time_us`) times a call as the reference's does, median and
IQR over ``reps`` samples after ``warmup`` calls: between CUDA events where
the call's tensors are on the card, on the host's clock otherwise."""
from __future__ import annotations

import dataclasses
import statistics
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


@dataclasses.dataclass(frozen=True)
class Sample:
    """A steady-state timing: the median of the timed calls, their
    interquartile range (the autotuner re-measures a sample whose IQR is
    over half its median rather than trust it) and the number of timed
    calls (warm-up calls excluded)."""
    median_us: float
    iqr_us: float
    reps: int


#: cycles of the spin kernel queued ahead of each timed sample on the card
#: (about 2 ms at the H100's 1.98 GHz boost clock): the host queues a
#: sample's calls while it spins, so the events time the device's work and
#: not the host's launches
SPIN_CYCLES = 4_000_000


def _on_card(args) -> bool:
    import torch
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def _clone(a):
    import torch
    return a.clone() if isinstance(a, torch.Tensor) else a


def measure_us(fn, *args, reps: int = 10, warmup: int = 2, inner: int = 1,
               copies: int = 1) -> Sample:
    """``fn(*args)`` timed over ``reps`` samples of ``inner`` calls each,
    after ``warmup`` discarded calls, as µs a call.  Where an argument is on
    the card, each sample lies between two CUDA events on the current
    stream, behind a spin kernel (``SPIN_CYCLES``) that keeps the device
    busy while the host queues the sample's calls; elsewhere the host's
    clock times it.  ``copies`` > 1: the calls take, in turn, ``args`` and
    ``copies - 1`` clones of its tensors (strides kept), so that where the
    copies together exceed a cache, no call finds its operands left there
    by the calls before it."""
    import torch

    card = _on_card(args)
    sets = [args] + [tuple(_clone(a) for a in args) for _ in range(copies - 1)]
    turn = [0]

    def call():
        a = sets[turn[0] % len(sets)]
        turn[0] += 1
        return fn(*a)

    call()
    for _ in range(warmup):
        call()
    n = max(reps, 1)
    inner = max(inner, 1)
    samples = []
    if card:
        torch.cuda.synchronize()
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            for _ in range(inner):
                call()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e3 / inner)
    else:
        for _ in range(n):
            t0 = now()
            for _ in range(inner):
                call()
            samples.append((now() - t0) * 1e6 / inner)
    if len(samples) >= 2:
        q1, _, q3 = statistics.quantiles(samples, n=4)
        iqr = q3 - q1
    else:
        iqr = 0.0
    return Sample(median_us=statistics.median(samples), iqr_us=iqr,
                  reps=len(samples))


def median_time_us(fn, *args, reps: int = 10, warmup: int = 2, inner: int = 1,
                   copies: int = 1) -> float:
    """The median of :func:`measure_us`, alone."""
    return measure_us(fn, *args, reps=reps, warmup=warmup, inner=inner,
                      copies=copies).median_us
