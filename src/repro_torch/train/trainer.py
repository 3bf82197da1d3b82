"""The train step: microbatched gradient accumulation, then AdamW.

The port's counterpart of ``repro.train.trainer`` (``TrainState``,
``train_state_defs``, ``make_train_step``, ``init_train_state``) for one
device.  Gradients come from ``torch.autograd.grad`` of
``lm.forward_train``, through the kernels' backwards on the card; they are
in each parameter's dtype, and microbatches accumulate them in
``acc_dtype``.  The gradient-sync hook and the sharding helpers come with
the distributed slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, ModelConfig
from repro_torch.models import lm
from repro_torch.params import init_params, tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.launches import LAUNCHES
from .optimizer import OptConfig, adamw_init, adamw_update, opt_state_defs


class TrainState(NamedTuple):
    params: Any
    opt: Any


def train_state_defs(cfg: ModelConfig, opt_cfg: OptConfig):
    pdefs = lm.model_defs(cfg)
    return pdefs, opt_state_defs(pdefs, opt_cfg)


def trainable(params: dict) -> dict:
    """The same tensors, each a leaf that autograd gives a gradient."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    """(loss, gradient tree) of ``lm.forward_train`` at ``params``."""
    loss = lm.forward_train(params, tokens, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    n_microbatches: int = 1, acc_dtype=torch.float32):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: ``{"tokens": (B, S) int tensor}`` on the parameters' device.
    Microbatches split the batch dim in order and accumulate gradients in
    ``acc_dtype``; the gradient is their mean, and so is the loss.  The
    update is written into ``state``'s tensors in place (``adamw_update``);
    metrics are ``{"lr", "grad_norm", "loss"}``, 0-d f32 tensors."""

    def train_step(state: TrainState, batch):
        tokens = batch["tokens"]
        B = tokens.shape[0]
        if n_microbatches == 1:
            loss, grads = loss_and_grads(state.params, tokens, cfg)
        else:
            if B % n_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{n_microbatches} microbatches")
            mb = B // n_microbatches
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                 device=p.device), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_microbatches):
                l, g = loss_and_grads(state.params, tokens[i * mb:(i + 1) * mb], cfg)
                for a, gi in zip(tree_leaves(acc), tree_leaves(g)):
                    a.add_(gi.to(acc_dtype))
                lsum = lsum + l
                del g
            grads = tree_map(lambda a: a / n_microbatches, acc)
            loss = lsum / n_microbatches
        params, opt, metrics = adamw_update(state.params, grads, state.opt,
                                            opt_cfg)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step


def _sublayer_counts(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(A, M, X, S): the model's attention, MLP, MoE and Mamba sublayers;
    raises for a kind the port does not run (cross-attention)."""
    kinds = [k for layer in cfg.layer_period for k in layer]
    if any(k not in (ATTN, MLP, MOE, MAMBA) for k in kinds):
        raise NotImplementedError("attention, MLP, MoE and Mamba sublayers "
                                  "only")
    return tuple(kinds.count(k) * cfg.n_periods for k in (ATTN, MLP, MOE, MAMBA))


def _norms_and_products(cfg: ModelConfig) -> tuple[int, int]:
    """A forward's rmsnorms and matmul launches in the layer periods: one
    norm an attention, MLP or MoE sublayer and two a Mamba one (its input
    and its gated output); 4 projections an attention, 3 an MLP, 3 for each
    of the E experts a MoE (every expert runs on its C buffer rows, tokens
    or none) and 2 a Mamba (``in_proj``, ``out_proj``)."""
    A, M, X, S = _sublayer_counts(cfg)
    return A + M + X + 2 * S, 4 * A + 3 * M + 3 * cfg.n_experts * X + 2 * S


def step_launches(cfg: ModelConfig, n_microbatches: int = 1) -> dict:
    """The kernel launches of one train step on the card, by counter.

    A microbatch's forward makes the layer periods' norms and products
    (:func:`_norms_and_products`: R and P) and one flash attention an
    attention sublayer (A); the loss adds the final rmsnorm.  Under
    ``cfg.remat`` the backward runs every period's forward again (the
    final norm is outside the periods).  The backward makes one rmsnorm
    backward a norm, two matmul products a projection (dX and dW: every
    projection's input and weight need a gradient, an expert's buffer rows
    too) and one flash backward an attention.  So, with r = 2 under remat,
    else 1, and n microbatches: rmsnorm n (R r + 1), matmul n P r,
    flash_attention n A r, rmsnorm_bwd n (R + 1), matmul_bwd 2 n P,
    flash_attention_bwd n A; the rest 0.  The MoE router, its dispatch and
    the SSD scan are plain torch and launch none of these."""
    A = _sublayer_counts(cfg)[0]
    R, P = _norms_and_products(cfg)
    r, n = (2 if cfg.remat else 1), n_microbatches
    return {"rmsnorm": n * (R * r + 1), "matmul": n * P * r,
            "flash_attention": n * A * r, "rmsnorm_bwd": n * (R + 1),
            "matmul_bwd": 2 * n * P, "flash_attention_bwd": n * A}


def serve_launches(cfg: ModelConfig, prefills: int = 0, decode_steps: int = 0,
                   *, chunks: int = 0, paged: bool = False) -> dict:
    """The kernel launches of a serving run on the card, by counter, from
    its forwards: ``prefills`` whole-prompt prefills, ``decode_steps``
    decode steps (through the dense cache, or the block pool if ``paged``)
    and ``chunks`` paged prefill chunks.

    Every forward makes the layer periods' norms and products
    (:func:`_norms_and_products`) and the final rmsnorm.  Attention (A
    sublayers) is one flash attention a whole-prompt prefill and one paged
    attention a paged decode step or chunk; dense-cache decode attention,
    like the Mamba conv, scan and recurrence, is plain torch."""
    A = _sublayer_counts(cfg)[0]
    R, P = _norms_and_products(cfg)
    fwd = prefills + decode_steps + chunks
    paged_fwd = chunks + (decode_steps if paged else 0)
    return {**{k: 0 for k in LAUNCHES}, "rmsnorm": (R + 1) * fwd,
            "matmul": P * fwd, "flash_attention": A * prefills,
            "paged_attention": A * paged_fwd}


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig,
                     generator: torch.Generator, device="cuda") -> TrainState:
    """Random trainable weights for ``cfg`` (``generator`` on ``device``)
    and their fresh optimizer state."""
    params = trainable(init_params(lm.model_defs(cfg), generator, device))
    return TrainState(params, adamw_init(params, opt_cfg))
