"""Front 2a: S2, ring-schedule safety.

The port's counterpart of ``repro.analysis.schedule_check``.  A shift
whose permutation is not a uniform circular shift covering its whole ring
leaves some rank waiting on a hop nobody sends (the odometer deadlock), or
moves different ranks over different numbers of wires, so that the ring's
cost model (hops x hop_lat) misprices.  Uniform shifts with
``gcd(shift, n) > 1`` are legal: recursive doubling decomposes into
gcd-many disjoint cycles that advance in lockstep.

:func:`check_ring_permutation` is the reference's, as it is.  The port has
no jaxpr to walk: the permutations checked are the ``pairs`` that
``parallel.comm`` records for each shift (``Mesh.records``), every
(source, target) mesh position pair of the shift.  The reference's
aliasing check (a donated Pallas buffer read while in flight) has no
counterpart: no kernel of the port aliases an input to an output.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.analysis import Finding


def check_ring_permutation(perm: Sequence[tuple[int, int]],
                           n: int) -> list[str]:
    """Problems with one ppermute permutation on an ``n``-ring (empty list
    when the permutation is a full-ring uniform circular shift)."""
    pairs = [tuple(p) for p in perm]
    problems = []
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    bad = [p for p in pairs
           if not (0 <= p[0] < n and 0 <= p[1] < n)]
    if bad:
        problems.append(f"pairs {bad} outside the {n}-ring")
        return problems
    if len(set(srcs)) != len(srcs):
        problems.append("duplicate sources (one buffer sent twice)")
    if len(set(dsts)) != len(dsts):
        problems.append("duplicate destinations (receive-side write race)")
    if problems:
        return problems
    if len(pairs) != n or set(srcs) != set(range(n)):
        idle = sorted(set(range(n)) - set(srcs))
        problems.append(
            f"partial ring: positions {idle} send nothing — their "
            f"neighbours wait forever (odometer deadlock)")
        return problems
    shifts = {(d - s) % n for s, d in pairs}
    if len(shifts) != 1:
        problems.append(
            f"non-uniform shift {sorted(shifts)}: hops differ per device, "
            f"so the ring cost model (hops x hop_lat) misprices")
    elif shifts == {0}:
        problems.append("zero shift (identity permutation moves no data)")
    return problems


def group_permutation(rec: dict) -> tuple[list[tuple[int, int]], int]:
    """A shift record's pairs within its group (``members``), as group
    indices, and the group's size."""
    members = list(rec["members"])
    index = {m: i for i, m in enumerate(members)}
    # a pair that leaves the group shows as an index outside the ring
    local = [(index.get(s, len(members)), index.get(d, len(members)))
             for s, d in rec["pairs"] if s in index or d in index]
    return local, len(members)


def check_permute_records(records, label: str) -> list[Finding]:
    """Run :func:`check_ring_permutation` on every recorded shift, over the
    ring of its group."""
    findings = []
    for rec in records:
        if rec["kind"] != "collective-permute":
            continue
        perm, n = group_permutation(rec)
        for prob in check_ring_permutation(perm, n):
            findings.append(Finding(
                "S2", label, 0,
                f"shift over a group of {n}: {prob}",
                "build shifts with parallel.comm.ppermute_shift so every "
                "step is a full-ring uniform circular shift"))
    return findings
