"""Ring attention: sequence-parallel attention with neighbour-only hops.

The port's counterpart of ``repro.parallel.ring_attention``.  The sequence
is cut over a ring of ranks; each rank keeps its queries' online-softmax
state while the K/V blocks travel one neighbour hop a step, so that after
a full turn every query has seen every key.

Two rings, by ``topology``:

* ``topology=None`` (flat): one ring over ``axis``, n - 1 hops.
* a ``Topology``: the sequence is cut over every level's dimensions
  (outer-major), and the K/V rotation walks the levels as an odometer: the
  innermost ring turns every step, a level-i ring once per full turn of
  the levels below it (each wrapped inner ring turning once more to close
  its cycle).  The long outer wires carry 1 / (product of the inner sizes)
  of the steps.  The two rings visit the blocks in other orders, so they
  agree to the re-association of the online softmax's sums.

Two schedules, by ``schedule``: ``"seq"`` computes on block k and then
fetches block k+1; ``"db"`` issues block k+1's ``batch_isend_irecv`` before
block k's compute and waits for it after, so the transfer can run under
the math.  The blocks and the arithmetic are the same: the same bits.

The block math is plain f32 torch (``_block_attn`` returns the (m, l, o)
partials the merge needs, which the flash kernel does not), as the
reference's is plain jnp.  Causal, sliding-window and GQA (the kv heads
repeated).  Forward only: the hops carry no gradient.
"""
from __future__ import annotations

import math

import torch

from repro_torch.topology import Topology, mesh_levels
from .comm import Mesh, ppermute_start


def _block_attn(q, k, v, q_pos, k_pos, scale: float, causal: bool, window):
    """One block's partials: q (B, Sq, H, D), k/v (B, T, H, D) f32 ->
    (m, l, o): the rows' max (B, H, Sq, 1), exp-sum and unnormalised
    output (B, H, Sq, D)."""
    s = torch.einsum("bqhd,bthd->bhqt", q, k) * scale
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask[None, None], s, -math.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.clamp(m, min=-1e30)                             # empty rows
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqt,bthd->bhqd", p, v)
    return m, l, o


def _ring_levels(mesh: Mesh, axis: str, topology: Topology | None) -> list:
    """The rotation rings as (dimensions, size), outermost first."""
    if topology is None:
        return [((axis,), mesh.shape[axis])]
    return mesh_levels(topology, mesh.shape)


def ring_attention(q, k, v, mesh: Mesh, *, axis: str = "data",
                   topology: Topology | None = None, causal: bool = True,
                   window: int | None = None, schedule: str = "seq"):
    """This rank's block of attention: q (B, S_loc, H, D), k/v (B, S_loc,
    Hkv, D), the rank's slice of a sequence cut over the ring (outer-major
    over ``topology``'s level dimensions, or over ``axis``) -> (B, S_loc,
    H, D) in q's dtype.  One shift a step (an odometer wrap shifts each
    wrapped inner ring once more)."""
    if schedule not in ("seq", "db"):
        raise ValueError(f"schedule must be 'seq' or 'db', got {schedule!r}")
    B, S_loc, H, D = q.shape
    G = H // k.shape[2]
    levels = _ring_levels(mesh, axis, topology)
    sizes = [s for _, s in levels]
    n = math.prod(sizes)
    scale = 1.0 / math.sqrt(D)
    strides, acc = [], 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    strides = list(reversed(strides))
    coords = [mesh.index(axes) for axes, _ in levels]
    pos = sum(c * st for c, st in zip(coords, strides))
    dev = q.device
    q_pos = pos * S_loc + torch.arange(S_loc, device=dev)
    qf = q.to(torch.float32)
    m = torch.full((B, H, S_loc, 1), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S_loc, 1), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, S_loc, D), dtype=torch.float32, device=dev)
    # k and v travel together, in their dtype and kv heads; each step
    # widens its block to f32 and repeats the kv heads (the values the
    # reference rotates, in 2 x G x fewer bytes a hop from bf16)
    kv = torch.stack([k, v])
    offsets = [0] * len(levels)                    # the rotation odometer

    def advance(kv):
        """One odometer tick, as (dimensions, hop) shifts applied in order
        to the block; returns the block in flight after the last."""
        i = len(levels) - 1
        hops = []
        while offsets[i] == sizes[i] - 1:          # complete an inner cycle
            hops.append(levels[i][0])
            offsets[i] = 0
            i -= 1
        hops.append(levels[i][0])                  # one hop on ring i
        offsets[i] += 1
        for axes in hops[:-1]:
            kv = ppermute_start(kv, axes, 1, mesh).wait()
        return ppermute_start(kv, hops[-1], 1, mesh)

    for step in range(n):
        src = sum(((c + off) % s) * st for c, off, s, st in
                  zip(coords, offsets, sizes, strides))
        k_pos = src * S_loc + torch.arange(S_loc, device=dev)
        if schedule == "db" and step < n - 1:
            # issue the hop(s) fetching block step+1 now: they depend only
            # on this block, not on its compute
            inflight = advance(kv)
        kf = kv.to(torch.float32)
        if G > 1:
            kf = torch.repeat_interleave(kf, G, dim=3)
        mb, lb, ob = _block_attn(qf, kf[0], kf[1], q_pos, k_pos, scale,
                                 causal, window)
        del kf
        m_new = torch.maximum(m, mb)
        alpha = torch.exp(torch.where(torch.isfinite(m), m - m_new, -math.inf))
        beta = torch.exp(torch.where(torch.isfinite(mb), mb - m_new, -math.inf))
        l = l * alpha + lb * beta
        o = o * alpha + ob * beta
        m = m_new
        if step < n - 1:
            kv = (inflight if schedule == "db" else advance(kv)).wait()
    safe = torch.where(l == 0.0, 1.0, l)
    return (o / safe).transpose(1, 2).to(q.dtype)
