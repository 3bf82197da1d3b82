"""Collectives over the named dimensions of a process mesh.

The port's counterpart of ``substrate.shard_map``'s collectives
(``axis_index``, ``psum``, ``pmax``, ``all_gather``, ``psum_scatter``,
``all_to_all``) and of ``repro.core.ring.ppermute_shift``.  A JAX program
runs one body on every device of a mesh; here every rank is a process that
runs the body on its own block, and the collectives are
``torch.distributed`` calls on the process group of the mesh dimensions
they name.

**The mesh.**  :class:`Mesh` names its dimensions outermost first; rank r
sits at the row-major coordinates of r (``init_device_mesh``'s layout).
Every collective takes a tuple of dimensions, flattened outer-major, as
the reference's ``maxes`` are: the group of ``("pod", "data")`` is the
ranks that share every other coordinate, and a rank's place in it is
``pod * |data| + data`` (:meth:`Mesh.index`).  The tuple must name the
dimensions in the mesh's order.  A mesh built by :meth:`Mesh.abstract`
has no process group: the rule table (``parallel.sharding``) and
``shard_tree`` read it, and nothing communicates.  A mesh over some of
the process group's ranks (:meth:`Mesh.over_ranks`, the survivors of a
rescale) maps its positions to their global ranks (``ranks``); only its
members make its groups.

**The backend** is a plain function of the layout (:func:`layout`): gloo
on the CPU; NCCL where every rank has a card of its own; gloo where ranks
share a card, and then every CUDA tensor crosses through a host buffer
(``transport="host"``: copied to the CPU, sent, copied back), since NCCL
refuses two ranks of one communicator on one device.  No call switches
backend, and compute stays on the card.

**Gradients.**  Each collective that autograd may differentiate is an
``autograd.Function`` of this module, paired with its transpose:

    psum            forward all-reduce, backward identity
    copy_to_group   forward identity, backward all-reduce
    all_gather      forward all-gather, backward reduce-scatter
    reduce_scatter  forward reduce-scatter, backward all-gather
    all_to_all      forward all-to-all, backward the inverse all-to-all
    split           forward this rank's chunk, backward all-gather
    gather          forward all-gather, backward this rank's chunk

A psum's backward is the identity only where the cotangent of its result
is the same on every rank of the group (the result feeds replicated
compute, as a tensor-parallel layer's output does); ``copy_to_group``
marks where a replicated input enters rank-local compute, so that the
ranks' partial gradients are summed.  ``all_gather`` is for a result that
each rank uses in its own way (its gradient is a sum over the ranks),
``gather`` for one that feeds replicated compute.  ``pmax`` and
``ppermute_shift`` carry no gradient.

Each rank counts its collectives' calls, the bytes it sent and the host
seconds spent inside them (copies through the host included) in
``Mesh.stats``.  The bytes are what the collective's bandwidth-optimal
(ring) schedule sends from one rank of a group of n, not the tensor it is
handed: an all-reduce 2(n-1)/n of the tensor, a reduce-scatter and an
all-to-all (n-1)/n of it, an all-gather (n-1) blocks, a shift the block.
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.testing.timing import now


def layout(device_type: str, world_size: int, n_cards: int) -> tuple[str, str]:
    """(backend, transport) of ``world_size`` ranks computing on
    ``device_type`` with ``n_cards`` cards: gloo and direct on the CPU,
    NCCL and direct with a card a rank, gloo through host buffers where
    ranks share a card."""
    if device_type == "cpu":
        return "gloo", "direct"
    if n_cards >= world_size:
        return "nccl", "direct"
    return "gloo", "host"


def rank_device(device_type: str, rank: int, n_cards: int) -> torch.device:
    """The device rank ``rank`` computes on: the CPU, or card
    ``rank % n_cards``."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % n_cards)


class World:
    """This process's place in the process group, from :func:`init_world`."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, transport: str):
        self.rank, self.size, self.device = rank, size, device
        self.backend, self.transport = backend, transport

    def describe(self) -> str:
        return (f"{self.size} ranks on {self.device.type}, backend "
                f"{self.backend}, transport {self.transport}")


def init_world(device_type: str, rank: int, world_size: int,
               init_method: str) -> World:
    """Join the process group (``init_method`` a ``file://`` store or a
    ``tcp://localhost:<port>`` address) with the backend :func:`layout`
    gives, set this rank's card, and print the choice (rank 0)."""
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and n_cards == 0:
        raise RuntimeError("init_world('cuda'): CUDA is not available")
    backend, transport = layout(device_type, world_size, n_cards)
    device = rank_device(device_type, rank, n_cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    world = World(rank, world_size, device, backend, transport)
    if rank == 0:
        print(f"[dist] {world.describe()}"
              + (f" ({world_size} ranks share {n_cards} card(s): each CUDA "
                 f"tensor a collective sends is copied through a host buffer)"
                 if transport == "host" else ""), flush=True)
    return world


def current_world(device_type: str) -> World:
    """This process's ``World`` in the process group it has joined, the
    transport :func:`layout` gives for ranks computing on ``device_type``."""
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    size, rank = dist.get_world_size(), dist.get_rank()
    _, transport = layout(device_type, size, n_cards)
    return World(rank, size, rank_device(device_type, rank, n_cards),
                 dist.get_backend(), transport)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A named process mesh: dimension names outermost first, their sizes,
    this process's rank, and a process group for every tuple of dimensions
    (built together by every rank when the mesh is made over a process
    group).  ``shape`` maps names to sizes, as a JAX mesh's does."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int], *,
                 rank: int = 0, transport: str | None = None,
                 device_mesh=None, ranks: Sequence[int] | None = None):
        self.axis_names = tuple(names)
        self.sizes = tuple(int(s) for s in sizes)
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(names)} names for {len(sizes)} sizes")
        self.shape = dict(zip(self.axis_names, self.sizes))
        self.size = math.prod(self.sizes)
        #: the global rank at each mesh position (``rank`` is a position)
        self.ranks = tuple(range(self.size)) if ranks is None else \
            tuple(int(r) for r in ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"{len(self.ranks)} ranks for a mesh of {self.size}")
        self.rank = rank
        self.transport = transport
        self.device_mesh = device_mesh
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
        self._groups: dict = {}
        self._members: dict = {}
        if transport is not None:
            self._build_groups()

    @classmethod
    def abstract(cls, sizes: Sequence[int], names: Sequence[str]) -> "Mesh":
        """A mesh with no process group (``jax.sharding.AbstractMesh``'s
        counterpart): the rule table and ``shard_tree`` read it."""
        return cls(names, sizes)

    @classmethod
    def over_ranks(cls, ranks: Sequence[int], sizes: Sequence[int],
                   names: Sequence[str], transport: str) -> "Mesh":
        """A mesh of ``sizes`` over the global ``ranks`` (mesh position p
        is ``ranks[p]``), made by those ranks alone: the survivor mesh of
        an elastic rescale, while the lost ranks take no part."""
        return cls(names, sizes, rank=list(ranks).index(dist.get_rank()),
                   transport=transport, ranks=ranks)

    @classmethod
    def from_device_mesh(cls, device_mesh, transport: str) -> "Mesh":
        """The mesh of a ``DeviceMesh`` with named dimensions (its
        one-dimension groups taken from it, the groups of several
        dimensions made here)."""
        return cls(device_mesh.mesh_dim_names, tuple(device_mesh.shape),
                   rank=dist.get_rank(), transport=transport,
                   device_mesh=device_mesh)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    # -- coordinates ------------------------------------------------------------
    def coords(self, rank: int | None = None) -> tuple:
        """Row-major coordinates of ``rank`` (this rank by default)."""
        r = self.rank if rank is None else rank
        out = []
        for s in reversed(self.sizes):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))

    def canon(self, axes) -> tuple:
        """``axes`` as a tuple of known dimensions in the mesh's order."""
        axes = _axes(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh {self.shape} has no dimension {a!r}")
        order = sorted(axes, key=self.axis_names.index)
        if list(axes) != order or len(set(axes)) != len(axes):
            raise ValueError(f"dimensions {axes} must be distinct and in the "
                             f"mesh's order {self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.canon(axes))

    def index(self, axes, rank: int | None = None) -> int:
        """The flattened outer-major coordinate of ``rank`` over ``axes``
        (``axis_index``), which is its place in their group."""
        c = dict(zip(self.axis_names, self.coords(rank)))
        i = 0
        for a in self.canon(axes):
            i = i * self.shape[a] + c[a]
        return i

    # -- process groups -----------------------------------------------------------
    def _build_groups(self) -> None:
        """A group for every tuple of dimensions of more than one rank (a
        one-dimension group the ``DeviceMesh``'s own).  ``new_group`` is
        collective: every rank makes every group, in the same order, and
        keeps its own; a mesh over some of the ranks makes only its own
        groups, each synchronised among its members (:func:`_local_group`)."""
        sub = self.ranks != tuple(range(dist.get_world_size()))
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if self.axis_size(axes) == 1:
                    continue
                mine = self._peers(self.rank, axes)
                self._members[axes] = mine
                if k == 1 and self.device_mesh is not None:
                    self._groups[axes] = self.device_mesh.get_group(axes[0])
                    continue
                if sub:
                    self._groups[axes] = _local_group(
                        tuple(self.ranks[p] for p in mine))
                    continue
                for ranks in sorted({tuple(self._peers(r, axes))
                                     for r in range(self.size)}):
                    g = dist.new_group(list(ranks))
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _peers(self, rank: int, axes) -> list:
        """The ranks that share every coordinate outside ``axes`` with
        ``rank``, ascending (their place in the group is ``index``)."""
        c = self.coords(rank)
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        return [r for r in range(self.size)
                if all(self.coords(r)[i] == c[i] for i in keep)]

    def group(self, axes):
        """The process group of ``axes`` holding this rank (None where the
        dimensions hold one rank)."""
        axes = self.canon(axes)
        if self.axis_size(axes) == 1:
            return None
        if self.transport is None:
            raise RuntimeError(f"{self!r} is abstract: it has no process group")
        return self._groups[axes]

    def peer(self, axes, i: int) -> int:
        """The global rank at place ``i`` of this rank's group of ``axes``."""
        return self.ranks[self._members[self.canon(axes)][i]]


#: groups of a mesh over some of the ranks, by their global ranks: made
#: once a process, since a group's name is a hash of its ranks
_LOCAL_GROUPS: dict = {}


def _local_group(ranks: tuple):
    """The process group of the global ``ranks``, made by them alone
    (``use_local_synchronization``: the ranks outside it never call)."""
    if ranks not in _LOCAL_GROUPS:
        _LOCAL_GROUPS[ranks] = dist.new_group(list(ranks),
                                              use_local_synchronization=True)
    return _LOCAL_GROUPS[ranks]


# ---------------------------------------------------------------------------
# the collectives themselves (no autograd)
# ---------------------------------------------------------------------------

def _wire(mesh: Mesh, x: torch.Tensor, fresh: bool = False) -> torch.Tensor:
    """The buffer a collective sends: a contiguous copy on the host under
    the host transport, else x itself made contiguous (a copy where
    ``fresh``: the collective writes into it)."""
    if mesh.transport == "host" and x.is_cuda:
        return x.detach().to("cpu", copy=True)
    buf = x.detach().contiguous()
    return buf.clone() if fresh and buf.data_ptr() == x.data_ptr() else buf


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.device) if y.device != like.device else y


class _Timed:
    """Counts a collective's call, its bytes and its host seconds."""

    def __init__(self, mesh: Mesh, nbytes: int):
        self.mesh, self.nbytes = mesh, nbytes

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        st = self.mesh.stats
        st["calls"] += 1
        st["bytes"] += self.nbytes
        st["seconds"] += now() - self.t0
        return False


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_reduce_raw(x: torch.Tensor, axes, mesh: Mesh,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of x over the group of ``axes``, a new tensor (every
    rank of the group gets the same bits)."""
    g = mesh.group(axes)
    if g is None:
        return x.detach().clone()
    n = mesh.axis_size(axes)
    with _Timed(mesh, 2 * (n - 1) * _nbytes(x) // n):
        buf = _wire(mesh, x, fresh=True)
        dist.all_reduce(buf, op=op, group=g)
        return _back(buf, x)


def all_gather_raw(x: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` in group order."""
    g = mesh.group(axes)
    if g is None:
        return x.detach().clone()
    n = mesh.axis_size(axes)
    with _Timed(mesh, (n - 1) * _nbytes(x)):
        buf = _wire(mesh, x)
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=g)
        return _back(torch.cat(parts, dim=dim), x)


def reduce_scatter_raw(x: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's chunk (its place in the group) along ``dim`` of the
    group's sum (``psum_scatter`` with ``tiled=True``): one reduce-scatter,
    each rank receiving the sum of its own chunk only."""
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    g = mesh.group(axes)
    if g is None:
        return x.detach().clone()
    with _Timed(mesh, (n - 1) * _nbytes(x) // n):
        buf = _wire(mesh, x.detach().movedim(dim, 0).contiguous())
        out = torch.empty_like(buf[:buf.shape[0] // n])
        dist.reduce_scatter(out, list(buf.chunk(n)), group=g)
        return _back(out, x).movedim(0, dim).contiguous()


def all_to_all_raw(x: torch.Tensor, axes, mesh: Mesh, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``split_axis`` cut into n
    chunks, chunk i to the group's rank i, the chunks received
    concatenated along ``concat_axis`` in source order."""
    g = mesh.group(axes)
    if g is None:
        return x.detach().clone()
    n = mesh.axis_size(axes)
    if x.shape[split_axis] % n:
        raise ValueError(f"split axis {split_axis} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    with _Timed(mesh, (n - 1) * _nbytes(x) // n):
        send = _wire(mesh, torch.stack(x.detach().chunk(n, dim=split_axis)))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=g)
        return _back(torch.cat(recv.unbind(0), dim=concat_axis), x)


class Pending:
    """A collective in flight (:func:`all_reduce_start`,
    :func:`ppermute_start`); ``wait`` returns its result on x's device."""

    def __init__(self, mesh: Mesh, works, buf, like, keep=None):
        self.mesh, self.works, self.buf, self.like = mesh, works, buf, like
        self.keep = keep                    # a send buffer, alive until the wait

    def wait(self) -> torch.Tensor:
        t0 = now()
        for w in self.works:
            w.wait()
        out = _back(self.buf, self.like)
        self.mesh.stats["seconds"] += now() - t0
        return out


def all_reduce_start(x: torch.Tensor, axes, mesh: Mesh) -> Pending:
    """Issue the sum of x over the group of ``axes`` (``async_op=True``)."""
    g = mesh.group(axes)
    if g is None:
        return Pending(mesh, [], x.detach().clone(), x)
    n = mesh.axis_size(axes)
    with _Timed(mesh, 2 * (n - 1) * _nbytes(x) // n):
        buf = _wire(mesh, x, fresh=True)
        return Pending(mesh, [dist.all_reduce(buf, group=g, async_op=True)], buf, x)


def ppermute_start(x: torch.Tensor, axes, shift: int, mesh: Mesh) -> Pending:
    """Issue a ring shift over the group of ``axes``: this rank sends x to
    the rank ``shift`` places behind it and receives the block of the rank
    ``shift`` places ahead (``core.ring.ppermute_shift``: position p
    receives from p + shift), as one ``batch_isend_irecv``."""
    n = mesh.axis_size(axes)
    if n == 1 or shift % n == 0:
        return Pending(mesh, [], x.detach().clone(), x)
    g = mesh.group(axes)
    i = mesh.index(axes)
    with _Timed(mesh, _nbytes(x)):
        send = _wire(mesh, x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, mesh.peer(axes, (i - shift) % n),
                          group=g),
               dist.P2POp(dist.irecv, recv, mesh.peer(axes, (i + shift) % n),
                          group=g)]
        return Pending(mesh, dist.batch_isend_irecv(ops), recv, x, keep=send)


def ppermute_shift(x: torch.Tensor, axes, shift: int, mesh: Mesh) -> torch.Tensor:
    """Receive the block of the rank ``shift`` places ahead on the ring of
    ``axes`` (no gradient)."""
    return ppermute_start(x, axes, shift, mesh).wait()


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------

def axis_index(axes, mesh: Mesh) -> int:
    """This rank's flattened outer-major coordinate over ``axes``."""
    return mesh.index(axes)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return all_reduce_raw(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.axes, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.args = (axes, mesh, dim)
        return all_gather_raw(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.args = (axes, mesh, dim)
        return reduce_scatter_raw(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, split_axis, concat_axis):
        ctx.args = (axes, mesh, split_axis, concat_axis)
        return all_to_all_raw(x, axes, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, split_axis, concat_axis = ctx.args
        return all_to_all_raw(g, axes, mesh, concat_axis, split_axis), \
            None, None, None, None


def _own_chunk(x, axes, mesh, dim):
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    return x.chunk(n, dim=dim)[mesh.index(axes)].contiguous()


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.args = (axes, mesh, dim)
        return _own_chunk(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, *ctx.args), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, dim):
        ctx.args = (axes, mesh, dim)
        return all_gather_raw(x, axes, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, *ctx.args), None, None, None


def _trivial(axes, mesh) -> bool:
    return mesh is None or not _axes(axes) or mesh.axis_size(axes) == 1


def psum(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """Sum over the group of ``axes``; backward the identity (the result
    feeds compute that every rank of the group repeats)."""
    return x if _trivial(axes, mesh) else _Psum.apply(x, _axes(axes), mesh)


def copy_to_group(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The identity; backward a psum over ``axes``: where a replicated x
    enters compute that each rank of the group does on its own shard."""
    return x if _trivial(axes, mesh) else _CopyToGroup.apply(x, _axes(axes), mesh)


def pmax(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """Max over the group of ``axes`` (no gradient: the callers subtract it
    from what it bounds, where it cancels)."""
    if _trivial(axes, mesh):
        return x.detach()
    return all_reduce_raw(x, _axes(axes), mesh, op=dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``; backward a
    reduce-scatter (each rank uses the whole in its own way)."""
    return x if _trivial(axes, mesh) else _AllGather.apply(x, _axes(axes), mesh, dim)


def reduce_scatter(x: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the group's sum; backward an
    all-gather."""
    if _trivial(axes, mesh):
        return x
    return _ReduceScatter.apply(x, _axes(axes), mesh, dim)


def all_to_all(x: torch.Tensor, axes, mesh: Mesh, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axes, split_axis, concat_axis, tiled=True)``;
    backward the inverse exchange."""
    if _trivial(axes, mesh):
        return x
    return _AllToAll.apply(x, _axes(axes), mesh, split_axis, concat_axis)


def split(x: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a replicated x; backward an
    all-gather of the chunks' gradients."""
    return x if _trivial(axes, mesh) else _Split.apply(x, _axes(axes), mesh, dim)


def gather(x: torch.Tensor, axes, mesh: Mesh, dim: int) -> torch.Tensor:
    """The group's blocks concatenated along ``dim`` into a replicated
    result; backward this rank's chunk of its (replicated) gradient."""
    return x if _trivial(axes, mesh) else _Gather.apply(x, _axes(axes), mesh, dim)


__all__ = ["layout", "rank_device", "World", "init_world", "current_world", "Mesh",
           "axis_index",
           "psum", "copy_to_group", "pmax", "all_gather", "reduce_scatter",
           "all_to_all", "split", "gather", "ppermute_start", "ppermute_shift",
           "all_reduce_raw", "all_gather_raw", "reduce_scatter_raw",
           "all_to_all_raw", "all_reduce_start", "Pending"]
