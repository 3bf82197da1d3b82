"""Parameter definitions, random init and the carry-over from JAX weights.

The port's counterpart of ``repro.parallel.sharding``'s ``PV`` /
``init_params`` (without sharding) and of the tree assembly in
``repro.models.lm``.  A param tree is a nested ``dict`` whose nesting and
leaf names are the JAX tree's (``period.l0.s0_attn.wq``, each period leaf
stacked over ``n_periods``), so carrying weights across is a tree-map.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class PV:
    """Parameter definition: shape, dtype and init law.  ``logical`` keeps
    the JAX tree's logical axis names; the port does not shard."""
    shape: tuple
    dtype: Any = torch.float32
    logical: tuple = ()
    init: str = "normal"         # normal | zeros | ones
    scale: float | None = None   # stddev override


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested-dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested-dict tree, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves) -> dict:
    """A tree shaped like ``tree`` whose leaves are ``leaves``, in the
    order of :func:`tree_leaves`."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _init_one(pv: PV, generator: torch.Generator, device) -> torch.Tensor:
    if pv.init == "zeros":
        return torch.zeros(pv.shape, dtype=pv.dtype, device=device)
    if pv.init == "ones":
        return torch.ones(pv.shape, dtype=pv.dtype, device=device)
    fan_in = pv.shape[-2] if len(pv.shape) >= 2 else pv.shape[-1]
    std = pv.scale if pv.scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    # drawn in f32 and cast, as the JAX initialiser does; a stacked leaf (a
    # period's weights on a leading axis) one leading slice at a time into
    # the leaf, so the f32 draw is one period's, not the whole stack's
    out = torch.empty(pv.shape, dtype=pv.dtype, device=device)
    for part in (out if out.ndim >= 3 else (out,)):
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device).mul_(std))
    return out


def init_params(defs, generator: torch.Generator, device="cuda") -> dict:
    """Random weights for a ``PV`` tree.  ``generator`` must live on
    ``device``.  The numbers differ from ``jax.random``'s for the same seed;
    parity runs carry JAX weights over with :func:`params_from_jax`."""
    return tree_map(lambda pv: _init_one(pv, generator, device), defs)


def _leaf_from_numpy(a) -> torch.Tensor:
    a = np.array(a, copy=True)          # np.asarray(jax_array) is read-only
    if a.dtype.name == "bfloat16":      # ml_dtypes: torch.from_numpy refuses it
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree) -> dict:
    """The JAX param (or cache) tree, as numpy arrays, to the port's tree on
    the CPU.  Exact for f32 and bf16 leaves (bf16 goes through an exact f32
    copy)."""
    return tree_map(_leaf_from_numpy, tree)


def params_from_dotted(flat) -> dict:
    """A tree from ``{dotted path: array}`` (an ``np.load`` of an ``.npz``
    written by ``scripts/make_torch_smoke_weights.py``), each leaf copied as
    :func:`params_from_jax` copies it."""
    tree: dict = {}
    for key in flat:
        *parents, leaf = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _leaf_from_numpy(flat[key])
    return tree


class ParamTree(nn.Module):
    """A param tree as nested modules: ``state_dict`` keys are the tree's
    dotted paths, and ``.to(device)`` moves every leaf.  Leaves are frozen
    (no autograd, as serving wants); ``repro_torch.train.trainer.trainable``
    gives a tree of trainable leaves."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of this module's tensors (shared, not copied)."""
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out
