"""GLSU, the Global Load/Store Unit (AraXL §III-B.3), on a process mesh.

AraXL replaces Ara2's O(L²) all-to-all byte-mapping network between the
memory bus and the lanes' VRF chunks with a multi-level pipeline of
power-of-2 shifts (the Align stage) followed by an EW-aware Shuffle stage:
more pipeline levels, each cuttable with registers, for physical
scalability; long vectors tolerate the latency.  The port's counterpart of
``repro.core.glsu``: the byte map is the redistribution between

    memory layout    x[p*B : (p+1)*B] on ring position p   (how a burst arrives)
    register layout  x[b*n + p], row b of ring position p  (the striped VRF map)

and every position is a rank.  Two implementations:

``mode="staged"``: the paper's network.  log2(n) rounds; in round k a
    bucket moves 2**k ring positions forward iff bit k of its distance is
    set, each round one ``comm.ppermute_shift`` of the buckets that move.
    Under a hierarchical interconnect (``"two-level"`` and deeper) the
    Align stage walks the topology: log2(L) cluster-local lane rotations,
    then the outer rings, with a per-level carry for buckets that wrapped
    a boundary (multi-digit addition).  The same round count, and the long
    wires never carry inner-level traffic.  Needs ``B % n == 0`` (each
    position exchanges B/n elements with every other; ``vle`` pads to n²).

``mode="direct"``: one ``comm.all_to_all`` over the ring's dimensions, the
    flat exchange the paper argues against in hardware (the reference's
    XLA resharding).  Any B: each position sends every other the elements
    it owns, padded to the largest count.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.parallel import comm

from .layout import VectorMachineSpec
from .ring import _levels_inner_first, _resolve_hierarchy, ppermute_shift, ring_pos


# ---------------------------------------------------------------------------
# Host reference (pure numpy): the oracle of the tests.
# ---------------------------------------------------------------------------

def mem_to_reg_host(x: np.ndarray, C: int, L: int) -> np.ndarray:
    """(n*B,) memory order -> (B, C, L) striped."""
    return np.asarray(x).reshape(-1, C, L)


def reg_to_mem_host(reg: np.ndarray) -> np.ndarray:
    return np.asarray(reg).reshape(-1)


# ---------------------------------------------------------------------------
# The staged routing core (static schedule)
# ---------------------------------------------------------------------------

def _shift_round(buf: torch.Tensor, take: np.ndarray, axis_names, size: int,
                 step: int, mesh: comm.Mesh) -> torch.Tensor:
    """One Align round: the buckets ``take`` marks move ``step`` positions
    forward on the ring (each rank receives them from p - step); the rest
    stay.  Every rank of the ring has the same ``take``."""
    idx = np.flatnonzero(take)
    if idx.size == 0:
        return buf
    sel = torch.as_tensor(idx, device=buf.device)
    moved = ppermute_shift(buf[sel], axis_names, -step, size, mesh)
    buf = buf.clone()
    buf[sel] = moved
    return buf


def _route_buckets(buf: torch.Tensor, axis_names: Sequence[str], n: int,
                   mesh: comm.Mesh) -> torch.Tensor:
    """Route bucket o of ``buf`` (shape (n, m)) exactly o ring positions
    forward in log2(n) power-of-2 shift rounds: bucket o moves in round k
    iff bit k of o is set.  After routing, slot o on position d holds the
    bucket that originated at position (d - o) mod n."""
    assert n & (n - 1) == 0, "staged GLSU requires power-of-2 ring size"
    o = np.arange(n)
    k = 0
    while (1 << k) < n:
        buf = _shift_round(buf, (o >> k) & 1, axis_names, n, 1 << k, mesh)
        k += 1
    return buf


def _route_buckets_hier(buf: torch.Tensor, levels: Sequence, n: int,
                        mesh: comm.Mesh) -> torch.Tensor:
    """N-level Align: route bucket o exactly o flattened-ring positions
    forward, walking ``levels`` (innermost-first (axes, size) pairs) with
    per-level power-of-2 rotations, exactly multi-digit addition of o to
    the position's coordinates, carries included.

    At each level a bucket rotates by its digit of o plus the carry from
    the level below; a bucket that wrapped past this level's boundary
    (seen at the destination coordinate x' as x' < rot, or as a full-cycle
    rotation) carries +1 into the level above.  The carry depends only on
    the coordinate of the level below, which every rank of this level's
    ring shares, so sender and receiver agree on which buckets move."""
    o = np.arange(n)
    carry = np.zeros(n, dtype=np.int64)
    stride = 1
    for j, (axes, size) in enumerate(levels):
        assert size & (size - 1) == 0, \
            "hierarchical staged GLSU requires power-of-2 level sizes"
        digit = (o // stride) % size
        hops = digit + carry                          # in [0, size]
        rot = hops % size
        k = 0
        while (1 << k) < size:
            buf = _shift_round(buf, (rot >> k) & 1, axes, size, 1 << k, mesh)
            k += 1
        if j < len(levels) - 1:
            here = ring_pos(axes, mesh)
            carry = ((here < rot) | (hops >= size)).astype(np.int64)
        stride *= size
    return buf


def _route_buckets_two_level(buf: torch.Tensor, cluster_axes: Sequence[str],
                             C: int, lane_axes: Sequence[str], L: int,
                             mesh: comm.Mesh) -> torch.Tensor:
    """The two-level case of :func:`_route_buckets_hier`: log2(L)
    cluster-local lane rotations, then log2(C) inter-cluster rotations (+1
    hop for the buckets whose lane rotation wrapped the cluster)."""
    return _route_buckets_hier(
        buf, [(tuple(lane_axes), L), (tuple(cluster_axes), C)], C * L, mesh)


def n_staged_rounds(n: int) -> int:
    """Rounds the staged Align network runs for an n-position ring: log2(n)
    (a 1-lane machine routes nothing: 0)."""
    if n <= 1:
        return 0
    return int(math.log2(n))


def _make_router(spec: VectorMachineSpec, hierarchy: str | None):
    """The Align stage's routing schedule for ``spec`` (flat, or walking
    every topology level; None takes the spec's Topology's hierarchy)."""
    hierarchy = _resolve_hierarchy(spec, hierarchy)
    n, mesh = spec.n_total_lanes, spec.mesh
    if hierarchy == "flat":
        return lambda buf: _route_buckets(buf, spec.ring_axes, n, mesh)
    return lambda buf: _route_buckets_hier(buf, _levels_inner_first(spec), n,
                                           mesh)


def _index(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


# ---------------------------------------------------------------------------
# mem -> reg (vector load through the GLSU)
# ---------------------------------------------------------------------------

def _mem_to_reg_local(xloc: torch.Tensor, p: int, n: int, route) -> torch.Tensor:
    """This position's (B,) memory shard -> its (B,) striped column."""
    B = xloc.shape[0]
    assert B % n == 0, f"staged GLSU needs B % n == 0 (B={B}, n={n})"
    m = B // n
    # bucketing (the Shuffle table): element j goes to position j mod n;
    # bucket o = (d - p) mod n holds the elements for d = p + o, in order
    j = np.arange(B)
    order = np.argsort(((j % n) - p) % n * B + j)
    buckets = xloc[_index(order, xloc)].reshape(n, m)
    routed = route(buckets)                           # the Align rounds
    # assembly: slot o came from q = (p - o) mod n and fills rows q*m ...
    slot_of_src = np.argsort((p - np.arange(n)) % n)
    return routed[_index(slot_of_src, routed)].reshape(B)


def _direct_mem_to_reg(xloc: torch.Tensor, p: int, n: int, axes,
                       mesh: comm.Mesh) -> torch.Tensor:
    """One all-to-all: position p sends position d the elements
    ``i = p*B + j`` with ``i mod n == d``, in order, each message padded to
    ceil(B / n); d keeps, from each source in ring order, the elements it
    owns, which are its rows in order."""
    B = xloc.shape[0]
    m = -(-B // n)
    send_idx = np.full((n, m), B)                     # B: the zero pad slot
    for d in range(n):
        mine = np.flatnonzero((p * B + np.arange(B)) % n == d)
        send_idx[d, :mine.size] = mine
    padded = torch.cat([xloc, xloc.new_zeros(1)])
    recv = comm.all_to_all_raw(padded[_index(send_idx, xloc)], axes, mesh, 0, 0)
    take = np.concatenate([s * m + np.arange(
        np.count_nonzero((s * B + np.arange(B)) % n == p)) for s in range(n)])
    return recv.reshape(-1)[_index(take, recv)]


def mem_to_reg(spec: VectorMachineSpec, xloc: torch.Tensor, mode: str = "staged",
               hierarchy: str | None = None) -> torch.Tensor:
    """Vector load: this position's (B,) shard of the memory vector (the
    contiguous block p of n) -> its (B,) striped column."""
    n, p = spec.n_total_lanes, spec.ring_pos
    assert xloc.ndim == 1
    if mode == "direct":
        return _direct_mem_to_reg(xloc, p, n, spec.ring_axes, spec.mesh)
    return _mem_to_reg_local(xloc, p, n, _make_router(spec, hierarchy))


# ---------------------------------------------------------------------------
# reg -> mem (vector store through the GLSU)
# ---------------------------------------------------------------------------

def _reg_to_mem_local(col: torch.Tensor, d: int, n: int, route) -> torch.Tensor:
    B = col.shape[0]
    assert B % n == 0
    m = B // n
    # position d holds elements i = b*n + d, bound for memory position
    # q = b // m; the bucket for q is rows [q*m, (q+1)*m), offset (q - d) mod n
    b = np.arange(B)
    order = np.argsort(((b // m - d) % n) * B + b)
    buckets = col[_index(order, col)].reshape(n, m)
    routed = route(buckets)
    # assembly on memory position q (= d here): slot o came from
    # (q - o) mod n, carrying the elements of local j = t*n + source
    jj = np.arange(B)
    slot_of_j = (d - (jj % n)) % n
    return routed[_index(slot_of_j, routed), _index(jj // n, routed)]


def _direct_reg_to_mem(col: torch.Tensor, d: int, n: int, axes,
                       mesh: comm.Mesh) -> torch.Tensor:
    """One all-to-all: position d sends memory position q its elements
    ``i = b*n + d`` with ``i // B == q``, in order, padded to ceil(B / n);
    q places what each source sends at ``i - q*B``."""
    B = col.shape[0]
    m = -(-B // n)
    i_of_b = np.arange(B) * n + d
    send_idx = np.full((n, m), B)
    for q in range(n):
        mine = np.flatnonzero(i_of_b // B == q)
        send_idx[q, :mine.size] = mine
    padded = torch.cat([col, col.new_zeros(1)])
    recv = comm.all_to_all_raw(padded[_index(send_idx, col)], axes, mesh, 0, 0)
    flat, dest = [], []
    for s in range(n):
        i = np.arange(d * B, (d + 1) * B)
        i = i[i % n == s]
        flat.append(s * m + np.arange(i.size))
        dest.append(i - d * B)
    out = torch.empty_like(col)
    out[_index(np.concatenate(dest), col)] = \
        recv.reshape(-1)[_index(np.concatenate(flat), recv)]
    return out


def reg_to_mem(spec: VectorMachineSpec, col: torch.Tensor, mode: str = "staged",
               hierarchy: str | None = None) -> torch.Tensor:
    """Vector store: this position's (B,) striped column -> its (B,) shard
    of the memory vector (the contiguous block p of n)."""
    n, p = spec.n_total_lanes, spec.ring_pos
    if mode == "direct":
        return _direct_reg_to_mem(col, p, n, spec.ring_axes, spec.mesh)
    return _reg_to_mem_local(col, p, n, _make_router(spec, hierarchy))
