"""Logical-axis sharding: the rule table, and each rank's block of a tree.

The port's counterpart of ``repro.parallel.sharding``.  Every parameter is
declared once as a ``PV`` whose ``logical`` names one axis a dimension;
:class:`ShardingRules` maps those names onto the dimensions of a process
mesh (``parallel.comm.Mesh``), with the reference's table
(:func:`default_rules`):

    batch      activation batch                  -> (pod, data)
    seq        sequence (sequence-sharded cells) -> (pod, data)
    fsdp       parameters' ZeRO-3 dimension      -> (pod, data)
    model      heads / d_ff / experts / vocab    -> model
    kv         kv heads (where they divide)      -> model
    cache_seq  the decode cache's slots          -> model (decode cells)
    act_seq    the residual's sequence (SP)      -> model

``spec(logical)`` gives, a dimension each, the mesh dimensions the
dimension is cut over (an empty tuple: whole), the counterpart of a
PartitionSpec, and never maps one mesh dimension twice.  Nothing here
communicates: :func:`shard_tree` cuts a rank's block out of a whole tree
(weights cross from JAX as ``params_from_jax``, then ``shard_tree``), and
:func:`gather_tree` puts the ranks' blocks back together.  The layers issue
the collectives the placements imply.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.params import PV, init_params, tree_map
from .comm import Mesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Mesh | None = None
    rules: dict | None = None

    def axis(self, name: str | None):
        if not name or self.rules is None:
            return None
        return self.rules.get(name)

    def spec(self, logical: Sequence[str | None]) -> tuple:
        """A tuple of mesh-dimension tuples, one a tensor dimension (empty
        where the dimension is whole); ``()`` without a mesh."""
        if self.mesh is None:
            return ()
        phys, used = [], set()
        for name in logical:
            ax = self.axis(name)
            flat = tuple(a for a in (ax if isinstance(ax, tuple) else (ax,))
                         if a) if ax else ()
            # never map one mesh dimension twice in a single spec
            flat = tuple(a for a in flat if a not in used and a in self.mesh.shape)
            used.update(flat)
            phys.append(flat)
        return tuple(phys)


def default_rules(mesh: Mesh | None, *, seq_sharded: bool = False,
                  fsdp: bool = True, kv_heads: int | None = None,
                  cache_seq: str | None = None, act_seq: bool = False,
                  batch: int | None = None) -> ShardingRules:
    """The logical -> mesh map of one (config, shape) cell, the
    reference's: ``kv_heads`` cuts the kv heads over `model` only where
    they divide; ``cache_seq="model"`` cuts a decode cache's slots over
    `model` (the distributed-softmax merge); ``batch`` (the global batch)
    is cut over the data dimensions only where it divides."""
    if mesh is None:
        return ShardingRules(None, None)
    names = set(mesh.axis_names)
    dp = tuple(a for a in ("pod", "data") if a in names) or None
    dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1
    msize = mesh.shape.get("model", 1)
    rules = {
        "batch": dp if (batch is None or batch % max(1, dp_size) == 0) else None,
        "seq": dp if seq_sharded else None,
        "fsdp": dp if fsdp else None,
        "model": "model" if "model" in names else None,
        "kv": ("model" if ("model" in names and kv_heads
                           and kv_heads % msize == 0) else None),
        "cache_seq": cache_seq,
        "act_seq": "model" if (act_seq and "model" in names) else None,
        "cluster": "cluster" if "cluster" in names else None,
        "lane": "lane" if "lane" in names else None,
    }
    return ShardingRules(mesh, rules)


def logical_to_spec(rules: ShardingRules, logical) -> tuple:
    return rules.spec(logical)


def rule_axes(rules: ShardingRules, name: str) -> tuple:
    """The mesh dimensions the logical axis ``name`` maps to, in the
    mesh's order (``()`` off-mesh or unmapped)."""
    if rules.mesh is None:
        return ()
    ax = rules.axis(name)
    axes = () if ax is None else ((ax,) if isinstance(ax, str) else tuple(ax))
    return tuple(a for a in rules.mesh.axis_names if a in axes)


def cut_axes(spec: tuple, mesh: Mesh) -> tuple:
    """Every mesh dimension a spec cuts over, in the mesh's order."""
    used = {a for d in spec for a in d}
    return tuple(a for a in mesh.axis_names if a in used)


def param_placements(defs, rules: ShardingRules):
    """The spec of every leaf of a ``PV`` tree (``param_shardings``'
    counterpart: a placement, not a sharding object)."""
    return tree_map(lambda pv: rules.spec(pv.logical), defs)


def local_shape(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """A leaf's block shape on one rank."""
    if not spec:
        return tuple(shape)
    out = []
    for n, axes in zip(shape, spec):
        k = math.prod(mesh.shape[a] for a in axes)
        if n % k:
            raise ValueError(f"dimension of {n} does not split over {axes} "
                             f"({k} ranks) of {mesh.shape}")
        out.append(n // k)
    return tuple(out)


def block(t: torch.Tensor, spec: tuple, mesh: Mesh, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of the whole tensor t under ``spec``: each
    dimension cut into as many blocks as its mesh dimensions hold ranks,
    the block at the rank's outer-major coordinate over them (a copy)."""
    local_shape(t.shape, spec, mesh)       # divisibility
    for d, axes in enumerate(spec):
        if axes:
            k = math.prod(mesh.shape[a] for a in axes)
            t = t.chunk(k, dim=d)[mesh.index(axes, rank)]
    return t.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, defs, rules: ShardingRules, rank: int):
    """Rank ``rank``'s block of every leaf of a whole tree, by the
    placements of ``defs`` (a ``PV`` tree of the same nesting)."""
    if rules.mesh is None:
        return tree
    specs = param_placements(defs, rules)
    return _map2(lambda t, s: block(t, s, rules.mesh, rank), tree, specs)


def gather_tree(trees: Sequence, defs, rules: ShardingRules):
    """The whole tree from every rank's blocks (``trees[r]`` rank r's, on
    the CPU): the inverse of :func:`shard_tree`.  A block that several
    ranks hold (a dimension whole over some mesh dimensions) is taken from
    the first of them."""
    mesh = rules.mesh
    if mesh is None:
        return trees[0]
    specs = param_placements(defs, rules)

    def one(s, *blocks):
        if not any(s):
            return blocks[0]
        cut = [(d, axes) for d, axes in enumerate(s) if axes]
        grids = [math.prod(mesh.shape[a] for a in axes) for _, axes in cut]
        pieces = {}
        for r, b in enumerate(blocks):
            key = tuple(mesh.index(axes, r) for _, axes in cut)
            pieces.setdefault(key, b)

        def assemble(level, prefix):
            if level == len(cut):
                return pieces[prefix]
            d = cut[level][0]
            return torch.cat([assemble(level + 1, prefix + (i,))
                              for i in range(grids[level])], dim=d)
        return assemble(0, ())

    return _mapn(one, specs, *trees)


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _mapn(fn, specs, *trees):
    """``fn(spec, *leaves)`` over the trees, in the first tree's key order."""
    if isinstance(specs, dict):
        return {k: _mapn(fn, specs[k], *(t[k] for t in trees)) for k in trees[0]}
    return fn(specs, *trees)


def init_local_params(defs, rules: ShardingRules, generator: torch.Generator,
                      device) -> dict:
    """This rank's block of :func:`repro_torch.params.init_params`' whole
    tree (drawn whole from ``generator``, so every rank and a one-process
    run see the same weights, then cut leaf by leaf)."""
    whole = init_params(defs, generator, device)
    if rules.mesh is None:
        return whole
    specs = param_placements(defs, rules)
    return _map2(lambda t, s: block(t, s, rules.mesh, rules.mesh.rank),
                 whole, specs)


__all__ = ["PV", "ShardingRules", "default_rules", "logical_to_spec", "rule_axes",
           "cut_axes", "param_placements", "local_shape", "block", "shard_tree",
           "gather_tree", "init_local_params"]
