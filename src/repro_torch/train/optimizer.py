"""AdamW with dtype-configurable state and f32 master weights.

The port's counterpart of ``repro.train.optimizer``: plain PyTorch, as the
reference's optimizer is XLA's, not a Pallas kernel.  m and v are kept in
``state_dtype`` (bf16 halves their bytes), the master copy of a low-precision
parameter in f32, and the arithmetic runs in ``math_dtype``.  Each constant
is rounded to ``math_dtype`` before it is used, as ``jnp.asarray(c, mdt)``
does in the reference.

The reference returns new trees; :func:`adamw_update` writes the new values
into the tensors of ``params`` and ``state`` in place (one copy of the
model's state, not two, on the card) and returns the same trees.  A
layer-stacked leaf (``ndim >= 3``) is updated one slice of its leading axis
at a time, as the reference's ``fori_loop`` does for a stack of 8 or more,
and a matrix of more than ``UPDATE_ROWS_OF`` elements (a vocabulary's
embedding or head) in blocks of rows of about that size, so the f32
temporaries are one slice, not the leaf; the math is element-wise, so the
slicing changes no value.

Under a mesh (``rules``) every rank updates its own blocks; only the
gradient's norm, which clipping reads, crosses the ranks
(:func:`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.sharding import cut_axes, param_placements
from repro_torch.params import PV, tree_leaves, tree_map


#: a matrix with more elements than this is updated in blocks of rows of
#: about this many elements (its f32 temporaries: 128 MiB each)
UPDATE_ROWS_OF = 2**25


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: Any = torch.float32    # m, v
    master_fp32: bool = True            # keep an f32 master when params are low-precision
    math_dtype: Any = torch.float32     # the update's arithmetic


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to 10 %, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def opt_state_defs(param_defs, cfg: OptConfig) -> dict:
    """``PV`` tree of the optimizer state (the parameters' shapes)."""
    def per_param(pv: PV):
        out = {"m": PV(pv.shape, cfg.state_dtype, pv.logical, "zeros"),
               "v": PV(pv.shape, cfg.state_dtype, pv.logical, "zeros")}
        if cfg.master_fp32 and pv.dtype != torch.float32:
            out["master"] = PV(pv.shape, torch.float32, pv.logical, "zeros")
        return out

    return {"step": PV((), torch.int32, (), "zeros"),
            "params": tree_map(per_param, param_defs)}


def adamw_init(params, cfg: OptConfig) -> dict:
    """Zero moments, an f32 master copy of each low-precision parameter, and
    step 0, on the parameters' device."""
    def per_param(p):
        out = {"m": torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device),
               "v": torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)}
        if cfg.master_fp32 and p.dtype != torch.float32:
            out["master"] = p.detach().to(torch.float32, copy=True)
        return out

    device = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "params": tree_map(per_param, params)}


def global_norm(tree, rules=None, defs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32.
    Under a mesh (``rules``, with ``defs`` the ``PV`` tree of ``tree``'s
    leaves) each leaf's local sum of squares is summed over exactly the
    mesh dimensions the leaf is cut over, so a leaf whole on several ranks
    counts once: the leaves are grouped by those dimensions, each group's
    sum psummed once."""
    leaves = tree_leaves(tree)
    mesh = None if rules is None else rules.mesh
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                              for g in leaves))
    groups: dict = {}
    for g, spec in zip(leaves, tree_leaves(param_placements(defs, rules))):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        axes = cut_axes(spec, mesh)
        groups[axes] = groups[axes] + sq if axes in groups else sq
    return torch.sqrt(sum(comm.psum(v, axes, mesh) if axes else v
                          for axes, v in sorted(groups.items())))


def _leaf_states(state_params, params) -> list:
    """The per-parameter state dicts ({"m", "v"[, "master"]}), in the
    order of the parameters' leaves."""
    found = []

    def walk(s, p):
        if isinstance(p, dict):
            for k in p:
                walk(s[k], p[k])
        else:
            found.append(s)

    walk(state_params, params)
    return found


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig, rules=None, defs=None):
    """One AdamW step, written in place; returns (params, state, metrics)
    with metrics ``{"lr", "grad_norm"}`` (0-d f32 tensors).  Under a mesh
    the trees are this rank's blocks and ``defs`` their ``PV`` tree (for
    the norm's placements)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step).to(torch.float32)
    gnorm = global_norm(grads, rules, defs)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm else torch.ones((), dtype=torch.float32,
                                              device=gnorm.device))
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    mdt = cfg.math_dtype

    def c(x):                           # a constant rounded to the math dtype
        return torch.tensor(x, dtype=mdt, device=gnorm.device)

    b1, nb1, b2, nb2, eps = c(cfg.b1), c(1 - cfg.b1), c(cfg.b2), c(1 - cfg.b2), c(cfg.eps)
    # weight decay applies to matrices (and stacks of them) only
    decays = (c(0.0), c(cfg.weight_decay))
    lr_m, scale_m, b1c_m, b2c_m = lr.to(mdt), scale.to(mdt), b1c.to(mdt), b2c.to(mdt)

    def upd_leaf(p, g, s, decay):
        gf = g.to(mdt) * scale_m
        m = s["m"].to(mdt) * b1 + gf * nb1
        v = s["v"].to(mdt) * b2 + gf * gf * nb2
        upd = (m / b1c_m) / (torch.sqrt(v / b2c_m) + eps)
        master = s.get("master", p).to(mdt)
        master = master - lr_m * (upd + decay * master)
        s["m"].copy_(m)
        s["v"].copy_(v)
        if "master" in s:
            s["master"].copy_(master)
        p.copy_(master)

    for p, g, s in zip(tree_leaves(params), tree_leaves(grads),
                       _leaf_states(state["params"], params)):
        decay = decays[p.ndim >= 2]
        if p.ndim >= 3:
            for i in range(p.shape[0]):
                upd_leaf(p[i], g[i], {k: t[i] for k, t in s.items()}, decay)
        elif p.ndim == 2 and p.numel() > UPDATE_ROWS_OF:
            n = max(1, UPDATE_ROWS_OF // p.shape[1])
            for r in range(0, p.shape[0], n):
                upd_leaf(p[r:r + n], g[r:r + n], {k: t[r:r + n] for k, t in s.items()},
                         decay)
        else:
            upd_leaf(p, g, s, decay)
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


__all__ = ["OptConfig", "lr_schedule", "opt_state_defs", "adamw_init",
           "global_norm", "adamw_update"]
