"""A cell's shapes and its abstract inputs, as ``meta`` tensors.

The port's counterpart of ``repro.launch.specs`` (and of the reference's
``ShapeSpec``/``SHAPES`` and its registry's ``skip_shapes``): a cell is a
model configuration under one of four shapes, and its inputs are tensors on
the ``meta`` device (a shape and a dtype, no storage), each cut to one
rank's block under the cell's rules (``parallel.sharding``), as the
reference's ``ShapeDtypeStruct``s are cut by their shardings.  The dry run
(``launch.dryrun``) runs the cell's step on them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.parallel.sharding import (ShardingRules, local_shape,
                                           param_placements, rule_axes)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: the registry's noted skips: quadratic full attention at 524,288 tokens
#: (the reference's ``skip_shapes``; jamba, mamba2 and the windowed mixtral
#: run every shape)
_FULL_ATTN = {"deepseek-7b", "glm4-9b", "llama-3.2-vision-11b", "llama3-8b",
              "phi3-mini-3.8b", "qwen3-moe-235b-a22b", "seamless-m4t-large-v2"}
SKIP_SHAPES = {name: {"long_500k": "quadratic full attention at 524288 context"}
               for name in _FULL_ATTN}


def skip_reason(cfg: ModelConfig, shape_name: str) -> str | None:
    """Why the registry skips this cell, or None where it runs."""
    return SKIP_SHAPES.get(cfg.name, {}).get(shape_name)


def meta_tree(defs, rules: ShardingRules | None = None):
    """A ``PV`` tree as meta tensors of one rank's block shapes."""
    rules = rules or ShardingRules()
    specs = param_placements(defs, rules) if rules.mesh is not None else None

    def walk(d, s):
        if isinstance(d, dict):
            return {k: walk(d[k], None if s is None else s[k]) for k in d}
        shape = d.shape if s is None else local_shape(d.shape, s, rules.mesh)
        return torch.empty(shape, dtype=d.dtype, device="meta")
    return walk(defs, specs)


def local_batch(global_batch: int, rules: ShardingRules | None) -> int:
    """One rank's rows of the batch (the ``batch`` rule's dimensions)."""
    if rules is None or rules.mesh is None:
        return global_batch
    k = rules.mesh.axis_size(rule_axes(rules, "batch")) \
        if rule_axes(rules, "batch") else 1
    return global_batch // k


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                rules: ShardingRules | None = None) -> dict:
    """One rank's abstract inputs for one cell:

    train, prefill: {"tokens": (B, S) int32[, "ctx": (B, T, d_ctx) f32]}
    decode:         {"token": (B, 1) int32, "cache": <tree>, "pos": () int32}

    B this rank's rows; the decode cache a ``seq_len``-deep cache, this
    rank's block of it."""
    B, S = local_batch(shape.global_batch, rules), shape.seq_len
    meta = dict(device="meta")
    if shape.kind in ("train", "prefill"):
        out = {"tokens": torch.empty((B, S), dtype=torch.int32, **meta)}
        if cfg.family in ("encdec", "vlm"):
            out["ctx"] = torch.empty((B, lm.context_len(cfg, S), cfg.d_ctx),
                                     dtype=torch.float32, **meta)
        return out
    cache = meta_tree(lm.cache_defs(cfg, shape.global_batch, S), rules)
    return {"token": torch.empty((B, 1), dtype=torch.int32, **meta), "cache": cache,
            "pos": torch.empty((), dtype=torch.int32, **meta)}


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0
