"""RINGI, the AraXL ring interconnect, on a process mesh (§III-B.4).

AraXL joins adjacent vector clusters with a ring carrying 64 bit/cycle per
direction, because the dominant permutation patterns of long-vector code
are slide-by-1 (stencils, shifted products) and reductions, both
neighbour-only.  The port's counterpart of ``repro.core.ring``: each lane
is a rank, and a ring shift is ``parallel.comm.ppermute_shift`` over the
ring's mesh dimensions (position p receives from p + shift, the
reference's convention).

Two interconnect models, selected by ``hierarchy=`` (defaulting to the
hierarchy of the spec's shared :class:`repro_torch.topology.Topology`):

``"flat"``       the flattened ring of all n lanes (outer-major, the order
                 of the element striping): every collective is log2(n) or
                 n-1 hops on one ring.

``"two-level"``  the paper's hierarchy: collectives run first over the
(and deeper)     *lane* dimension inside each cluster (log2(L) short hops),
                 then over the *cluster* ring (log2(C) hops), then over
                 each further level outward (``"three-level"``: a pod
                 ring, ...); the long wires only carry aggregated payloads.

A full reduction is the paper's 4-stage pipeline: a local reduction of the
lane's VRF rows, log2(L) inter-lane hops, log2(C) inter-cluster hops, and
a free broadcast (recursive doubling leaves a total on every lane).

The ``*_local`` functions take this rank's block, the ring's dimensions
and the mesh; the wrappers at the bottom take a
:class:`~repro_torch.core.layout.VectorMachineSpec` and this rank's column.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.parallel import comm
from repro_torch.topology import check_hierarchy as _check_hierarchy

from .layout import VectorMachineSpec

MODES = ("ring", "xla")
SCHEDULES = ("seq", "db")


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, "
                         f"got {schedule!r}")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _resolve_hierarchy(spec: VectorMachineSpec, hierarchy: str | None) -> str:
    """None -> the hierarchy of the spec's shared Topology; an explicit
    string must be "flat" or spell the spec's own depth."""
    if hierarchy is None:
        return spec.topology.hierarchy
    _check_hierarchy(hierarchy, spec.topology.n_levels)
    return hierarchy


def _levels_inner_first(spec: VectorMachineSpec) -> list:
    """The spec's topology levels as (mesh-axes, size) pairs, innermost
    first: the walk order of the hierarchical collectives."""
    return list(reversed(spec.topology_levels()))


# ---------------------------------------------------------------------------
# Primitives on this rank's block
# ---------------------------------------------------------------------------

def ring_pos(axis_names: Sequence[str], mesh: comm.Mesh) -> int:
    return mesh.index(tuple(axis_names))


def ppermute_shift(x: torch.Tensor, axis_names: Sequence[str], shift: int,
                   n: int, mesh: comm.Mesh) -> torch.Tensor:
    """Receive the block of the rank ``shift`` positions ahead on the ring
    of ``axis_names`` (``n`` of them)."""
    assert mesh.axis_size(tuple(axis_names)) == n
    return comm.ppermute_shift(x, tuple(axis_names), shift, mesh)


def _fill_like(v: torch.Tensor, rows: int, fill) -> torch.Tensor:
    return torch.full((rows,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                      device=v.device)


# -- slides ------------------------------------------------------------------

def slide1down_local(x: torch.Tensor, axis_names: Sequence[str], n: int,
                     mesh: comm.Mesh, fill=0.0) -> torch.Tensor:
    """out[i] = in[i+1] on the striped layout, ``fill`` entering at the
    padded tail.

    This rank's column holds elements ``i = b*n + p``; element i+1 lives at
    position p+1 in the same row, except for the last lane, whose successor
    wraps to lane 0 one row down.  So one neighbour hop of the whole column
    and a row shift on the last lane only: AraXL's single-hop slide."""
    nbr = ppermute_shift(x, axis_names, 1, n, mesh)   # column of lane p+1 (mod n)
    if ring_pos(axis_names, mesh) == n - 1:             # lane 0's, one row on
        return torch.cat([nbr[1:], _fill_like(nbr, 1, fill)])
    return nbr


def slide1up_local(x: torch.Tensor, axis_names: Sequence[str], n: int,
                   mesh: comm.Mesh, fill=0.0) -> torch.Tensor:
    """out[i] = in[i-1], out[0] = fill (striped layout)."""
    nbr = ppermute_shift(x, axis_names, -1, n, mesh)  # column of lane p-1 (mod n)
    if ring_pos(axis_names, mesh) == 0:
        return torch.cat([_fill_like(nbr, 1, fill), nbr[:-1]])
    return nbr


def slidedown_local(x: torch.Tensor, axis_names: Sequence[str], n: int,
                    k: int, mesh: comm.Mesh, fill=0.0) -> torch.Tensor:
    """out[i] = in[i+k]: a ring hop of k mod n plus a row shift of k // n,
    one row more on the lanes whose source crossed the ring's end (AraXL:
    'slides larger than 1 are implemented using multiple 64-bit transfers
    or bypasses on the ring')."""
    hop, rows = k % n, k // n
    if hop:
        y = ppermute_shift(x, axis_names, hop, n, mesh)
        wrapped = ring_pos(axis_names, mesh) >= n - hop
    else:
        y, wrapped = x, False
    r = min(rows + 1 if wrapped else rows, y.shape[0])
    if r == 0:
        return y
    return torch.cat([y[r:], _fill_like(y, r, fill)])


# -- reductions ---------------------------------------------------------------

def ring_allreduce_local(x: torch.Tensor, axis_names: Sequence[str], n: int,
                         mesh: comm.Mesh,
                         op: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor] = torch.add,
                         ) -> torch.Tensor:
    """Recursive-doubling all-reduce built only from ring shifts: step k
    combines with the value ``2**k`` positions ahead (AraXL's log-tree
    stages, later stages riding several hops).  A ring that is not a power
    of two falls back to an exact (n-1)-step ring accumulation."""
    total = x
    k = 1
    while k < n:
        total = op(total, ppermute_shift(total, axis_names, k, n, mesh))
        k *= 2
    if (n & (n - 1)) != 0:
        total = x
        acc = x
        for _ in range(n - 1):
            acc = ppermute_shift(acc, axis_names, 1, n, mesh)
            total = op(total, acc)
    return total


def _reduce_fns(op: str):
    if op == "sum":
        return (lambda c: c.sum(0)), torch.add
    if op == "max":
        return (lambda c: c.amax(0)), torch.maximum
    if op == "min":
        return (lambda c: c.amin(0)), torch.minimum
    raise ValueError(f"unsupported reduction {op}")


def reduce_to_scalar_local(col: torch.Tensor, axis_names: Sequence[str], n: int,
                           mesh: comm.Mesh, op: str = "sum") -> torch.Tensor:
    """The paper's full 4-stage reduction of one column on the flattened
    ring (op in {sum, max, min}), a total on every lane."""
    local_red, comb = _reduce_fns(op)
    return ring_allreduce_local(local_red(col).reshape(1), axis_names, n,
                                mesh, comb)


def reduce_to_scalar_local_hier(col: torch.Tensor, levels: Sequence,
                                mesh: comm.Mesh, op: str = "sum") -> torch.Tensor:
    """The hierarchical reduction, one ring a topology level: the local
    reduction, then log-tree all-reduces walking ``levels`` (innermost
    first (axes, size) pairs) outward; no stage spans two levels."""
    local_red, comb = _reduce_fns(op)
    total = local_red(col).reshape(1)
    for axes, size in levels:
        total = ring_allreduce_local(total, axes, size, mesh, comb)
    return total


def reduce_to_scalar_local_two_level(col: torch.Tensor,
                                     cluster_axes: Sequence[str], C: int,
                                     lane_axes: Sequence[str], L: int,
                                     mesh: comm.Mesh,
                                     op: str = "sum") -> torch.Tensor:
    """The two-level case of :func:`reduce_to_scalar_local_hier`."""
    return reduce_to_scalar_local_hier(
        col, [(tuple(lane_axes), L), (tuple(cluster_axes), C)], mesh, op)


# -- ring all-gather / reduce-scatter -----------------------------------------

def _ring_order(chunks: list, axis_names: Sequence[str], n: int,
                mesh: comm.Mesh) -> torch.Tensor:
    """Rotate per-step arrival chunks into global ring order and flatten:
    arrival slot j holds the block of position (p + j) mod n, so global
    slot g <- arrival slot (g - p) mod n."""
    p = ring_pos(axis_names, mesh)
    stacked = torch.stack(chunks)                      # [n, ...] arrival order
    stacked = stacked[[(g - p) % n for g in range(n)]]
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


def ring_allgather_local(x: torch.Tensor, axis_names: Sequence[str], n: int,
                         mesh: comm.Mesh) -> torch.Tensor:
    """(n-1)-step ring all-gather along dim 0: every step each rank forwards
    the block it received last to its neighbour.  Returns the blocks of
    every position in ring order."""
    chunks = [x]
    cur = x
    for _ in range(n - 1):
        cur = ppermute_shift(cur, axis_names, 1, n, mesh)   # receive from p+1
        chunks.append(cur)
    return _ring_order(chunks, axis_names, n, mesh)


def ring_allgather_local_db(x: torch.Tensor, axis_names: Sequence[str], n: int,
                            mesh: comm.Mesh,
                            consume: Callable | None = None) -> torch.Tensor:
    """Double-buffered ring all-gather: the hop that fetches block j+1 is
    issued (``comm.ppermute_start``) before block j is consumed.
    ``consume(block, j)`` is applied to each block as it lands (the block of
    position (p + j) mod n); its outputs come back in ring order.  Without a
    consumer the result is bit-identical to :func:`ring_allgather_local`."""
    assert mesh.axis_size(tuple(axis_names)) == n
    chunks = []
    cur = x
    for j in range(n):
        nxt = comm.ppermute_start(cur, tuple(axis_names), 1, mesh) \
            if j < n - 1 else None
        chunks.append(consume(cur, j) if consume is not None else cur)
        cur = nxt.wait() if nxt is not None else None
    return _ring_order(chunks, axis_names, n, mesh)


def ring_allgather_local_hier(x: torch.Tensor, levels: Sequence,
                              mesh: comm.Mesh,
                              schedule: str = "seq") -> torch.Tensor:
    """Hierarchical all-gather walking ``levels`` (innermost first): L-1
    intra-cluster hops assemble each cluster's lane blocks, then C-1 ring
    hops exchange whole cluster blocks, ..., together the flattened
    outer-major ring order.  ``schedule="db"`` double-buffers each level."""
    local = (ring_allgather_local_db if schedule == "db"
             else ring_allgather_local)
    for axes, size in levels:
        x = local(x, axes, size, mesh)
    return x


def ring_allgather_local_two_level(x: torch.Tensor,
                                   cluster_axes: Sequence[str], C: int,
                                   lane_axes: Sequence[str], L: int,
                                   mesh: comm.Mesh) -> torch.Tensor:
    """The two-level case of :func:`ring_allgather_local_hier`."""
    return ring_allgather_local_hier(
        x, [(tuple(lane_axes), L), (tuple(cluster_axes), C)], mesh)


def ring_reduce_scatter_local(x: torch.Tensor, axis_names: Sequence[str],
                              n: int, mesh: comm.Mesh) -> torch.Tensor:
    """(n-1)-step ring reduce-scatter along dim 0: position p ends with
    chunk p of the sum over the ring, each step one neighbour hop."""
    assert x.shape[0] % n == 0
    p = ring_pos(axis_names, mesh)
    stacked = torch.stack(x.chunk(n))                  # [n, B/n, ...]
    acc = stacked[(p + 1) % n]                         # partial for chunk p+1
    for s in range(2, n + 1):
        acc = ppermute_shift(acc, axis_names, 1, n, mesh)  # partial for chunk p+s
        acc = acc + stacked[(p + s) % n]
    return acc                                         # fully summed chunk p


def ring_reduce_scatter_local_db(x: torch.Tensor, axis_names: Sequence[str],
                                 n: int, mesh: comm.Mesh,
                                 n_chunks: int = 2) -> torch.Tensor:
    """Chunked double-buffered ring reduce-scatter: the payload is cut into
    ``n_chunks`` pipelines along its last dim, and every step issues each
    pipeline's hop before any add consumes an arrival (one pipeline where
    the payload does not split).  The same additions in the same order as
    :func:`ring_reduce_scatter_local`: bit-identical."""
    assert x.shape[0] % n == 0
    p = ring_pos(axis_names, mesh)
    stacked = torch.stack(x.chunk(n))                  # [n, B/n, ...]
    if stacked.shape[-1] % n_chunks:
        n_chunks = 1
    parts = stacked.chunk(n_chunks, dim=-1)
    accs = [part[(p + 1) % n] for part in parts]
    axes = tuple(axis_names)
    for s in range(2, n + 1):
        shifted = [comm.ppermute_start(a, axes, 1, mesh) for a in accs]
        accs = [sh.wait() + part[(p + s) % n] for sh, part in zip(shifted, parts)]
    return torch.cat(accs, dim=-1) if n_chunks > 1 else accs[0]


def ring_reduce_scatter_local_hier(x: torch.Tensor, levels: Sequence,
                                   mesh: comm.Mesh,
                                   schedule: str = "seq") -> torch.Tensor:
    """Hierarchical reduce-scatter walking ``levels`` from the outside in:
    the outermost ring reduce-scatters its superchunks, then each inner
    level splits its chunk further; position p ends with chunk p of the
    total, as in the flat schedule."""
    local = (ring_reduce_scatter_local_db if schedule == "db"
             else ring_reduce_scatter_local)
    for axes, size in reversed(list(levels)):
        x = local(x, axes, size, mesh)
    return x


def ring_reduce_scatter_local_two_level(x: torch.Tensor,
                                        cluster_axes: Sequence[str], C: int,
                                        lane_axes: Sequence[str], L: int,
                                        mesh: comm.Mesh) -> torch.Tensor:
    """The two-level case of :func:`ring_reduce_scatter_local_hier`."""
    return ring_reduce_scatter_local_hier(
        x, [(tuple(lane_axes), L), (tuple(cluster_axes), C)], mesh)


# ---------------------------------------------------------------------------
# Whole-register ops of a VectorMachineSpec (on this rank's column)
# ---------------------------------------------------------------------------

def slide1down(spec: VectorMachineSpec, col: torch.Tensor,
               fill: float = 0.0) -> torch.Tensor:
    return slide1down_local(col, spec.ring_axes, spec.n_total_lanes,
                            spec.mesh, fill)


def slide1up(spec: VectorMachineSpec, col: torch.Tensor,
             fill: float = 0.0) -> torch.Tensor:
    return slide1up_local(col, spec.ring_axes, spec.n_total_lanes,
                          spec.mesh, fill)


def reduce_scalar(spec: VectorMachineSpec, col: torch.Tensor, op: str = "sum",
                  mode: str = "ring", hierarchy: str | None = None) -> torch.Tensor:
    """Full-register reduction, a 0-d tensor with the same bits on every
    rank.  mode='ring' is the paper's log-tree on neighbour hops, flat or
    walking every topology level from the lanes outward (``hierarchy``,
    default the spec's); each position's total is associated in its own
    order, so every rank takes position 0's (the value the reference reads
    back from its first device).  mode='xla' is one all-reduce of the local
    reductions (``comm.psum``/``pmax``; min as -pmax(-x)), the comparison
    point."""
    _check_mode(mode)
    hierarchy = _resolve_hierarchy(spec, hierarchy)
    axes, n, mesh = spec.ring_axes, spec.n_total_lanes, spec.mesh
    if mode == "xla":
        local, _ = _reduce_fns(op)
        x = local(col)
        if op == "sum":
            return comm.psum(x, axes, mesh)
        if op == "max":
            return comm.pmax(x, axes, mesh)
        return -comm.pmax(-x, axes, mesh)
    if hierarchy == "flat":
        r = reduce_to_scalar_local(col, axes, n, mesh, op)
    else:
        r = reduce_to_scalar_local_hier(col, _levels_inner_first(spec), mesh, op)
    return comm.all_gather_raw(r, axes, mesh, 0)[0]


def ring_allgather(spec: VectorMachineSpec, row: torch.Tensor,
                   mode: str = "ring", hierarchy: str | None = None,
                   schedule: str = "seq") -> torch.Tensor:
    """All-gather over the lane ring: ``row`` is this position's (B,)
    shard; returns the (n*B,) ring-order concatenation on every rank.
    mode='xla' is one ``comm`` all-gather; schedule='db' double-buffers
    the ring (bit-identical)."""
    _check_mode(mode)
    _check_schedule(schedule)
    hierarchy = _resolve_hierarchy(spec, hierarchy)
    axes, n, mesh = spec.ring_axes, spec.n_total_lanes, spec.mesh
    if mode == "xla":
        return comm.all_gather_raw(row, axes, mesh, 0)
    if hierarchy == "flat":
        return (ring_allgather_local_db if schedule == "db"
                else ring_allgather_local)(row, axes, n, mesh)
    return ring_allgather_local_hier(row, _levels_inner_first(spec), mesh,
                                     schedule)


def ring_reduce_scatter(spec: VectorMachineSpec, row: torch.Tensor,
                        mode: str = "ring", hierarchy: str | None = None,
                        schedule: str = "seq") -> torch.Tensor:
    """Reduce-scatter over the lane ring: ``row`` is this position's (M,)
    contribution (M % n == 0); returns chunk p (M // n) of the sum of every
    position's.  mode='xla' is one ``comm`` reduce-scatter; schedule='db'
    chunk-pipelines each ring (bit-identical sums)."""
    _check_mode(mode)
    _check_schedule(schedule)
    hierarchy = _resolve_hierarchy(spec, hierarchy)
    axes, n, mesh = spec.ring_axes, spec.n_total_lanes, spec.mesh
    assert row.shape[0] % n == 0, row.shape
    if mode == "xla":
        return comm.reduce_scatter_raw(row, axes, mesh, 0)
    if hierarchy == "flat":
        return (ring_reduce_scatter_local_db if schedule == "db"
                else ring_reduce_scatter_local)(row, axes, n, mesh)
    return ring_reduce_scatter_local_hier(row, _levels_inner_first(spec), mesh,
                                          schedule)
