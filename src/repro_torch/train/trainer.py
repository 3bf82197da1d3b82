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

from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, XATTN, ModelConfig
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


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   ctx: torch.Tensor | None = None):
    """(loss, gradient tree) of ``lm.forward_train`` at ``params`` (with the
    context ``ctx`` for the encdec and vlm families)."""
    loss = lm.forward_train(params, tokens, cfg, ctx)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    n_microbatches: int = 1, acc_dtype=torch.float32):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: ``{"tokens": (B, S) int tensor}`` on the parameters' device, and
    for the encdec and vlm families ``"ctx"``, (B, T, d_ctx) f32.
    Microbatches split the batch dim (of both) in order and accumulate
    gradients in
    ``acc_dtype``; the gradient is their mean, and so is the loss.  The
    update is written into ``state``'s tensors in place (``adamw_update``);
    metrics are ``{"lr", "grad_norm", "loss"}``, 0-d f32 tensors."""

    def train_step(state: TrainState, batch):
        tokens = batch["tokens"]
        ctx = batch.get("ctx")
        B = tokens.shape[0]
        if n_microbatches == 1:
            loss, grads = loss_and_grads(state.params, tokens, cfg, ctx)
        else:
            if B % n_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{n_microbatches} microbatches")
            mb = B // n_microbatches
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                 device=p.device), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                l, g = loss_and_grads(state.params, tokens[rows], cfg,
                                      None if ctx is None else ctx[rows])
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


def _sublayer_counts(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    """(A, M, X, S, Xa): the model's self-attention, MLP, MoE, Mamba and
    cross-attention sublayers."""
    kinds = [k for layer in cfg.layer_period for k in layer]
    return tuple(kinds.count(k) * cfg.n_periods
                 for k in (ATTN, MLP, MOE, MAMBA, XATTN))


def _norms_and_products(cfg: ModelConfig) -> tuple[int, int]:
    """A forward's rmsnorms and matmul launches in the layer periods, the
    cross-attention sublayers left out (R and P): one norm a self-attention,
    MLP or MoE sublayer and two a Mamba one (its input and its gated
    output); 4 projections an attention, 3 an MLP, 3 for each of the E
    experts a MoE (every expert runs on its C buffer rows, tokens or none)
    and 2 a Mamba (``in_proj``, ``out_proj``)."""
    A, M, X, S, _ = _sublayer_counts(cfg)
    return A + M + X + 2 * S, 4 * A + 3 * M + 3 * cfg.n_experts * X + 2 * S


def _context_counts(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """A forward's launches beyond the periods' R and P with a context:
    rmsnorms inside the layers, matmul launches and flash attentions of the
    Xa cross-attention sublayers (a norm, 4 projections: ``wq``; ``wk`` and
    ``wv`` on the context, made once, ``layers.xattn_layer_prefill``;
    ``wo``; a flash attention each) and, for encdec, of the Le encoder
    layers (2 norms, 7 projections, a flash attention each); and the
    norms outside them, the encoder's final one ([encdec]).  ``ctx_proj``
    is a plain ``torch.matmul`` and launches none."""
    Xa = _sublayer_counts(cfg)[4]
    encdec = int(cfg.family == "encdec")
    Le = cfg.n_enc_layers * encdec
    return Xa + 2 * Le, 4 * Xa + 7 * Le, Xa + Le, encdec


def step_launches(cfg: ModelConfig, n_microbatches: int = 1) -> dict:
    """The kernel launches of one train step on the card, by counter.

    A microbatch's forward makes the layer periods' norms and products
    (:func:`_norms_and_products`: R and P) and one flash attention a
    self-attention sublayer (A); with a context (:func:`_context_counts`:
    Xa cross-attention sublayers, Le encoder layers) also a norm, 4
    products and a flash attention a cross-attention sublayer and 2 norms,
    7 products and a flash attention an encoder layer, and the encoder's
    final norm ([encdec]); the loss adds the final rmsnorm.  Under
    ``cfg.remat`` the backward runs every period's and every encoder
    layer's forward again (the final norms are outside them).  The
    backward makes one rmsnorm backward a norm, two matmul products a
    projection (dX and dW: every projection's input and weight need a
    gradient, an expert's buffer rows and the context's rows too, since
    ``ctx_proj`` and the encoder train) and one flash backward an
    attention.  So, with r = 2 under remat, else 1, and n microbatches:
    rmsnorm n ((R + Xa + 2 Le) r + 1 + [encdec]), matmul n (P + 4 Xa + 7
    Le) r, flash_attention n (A + Xa + Le) r, rmsnorm_bwd n (R + Xa + 2 Le
    + 1 + [encdec]), matmul_bwd 2 n (P + 4 Xa + 7 Le), flash_attention_bwd
    n (A + Xa + Le); the rest 0.  The MoE router, its dispatch, the SSD
    scan and ``ctx_proj`` are plain torch and launch none of these."""
    A = _sublayer_counts(cfg)[0]
    R, P = _norms_and_products(cfg)
    Rc, Pc, Fc, Ro = _context_counts(cfg)
    R, P, F = R + Rc, P + Pc, A + Fc
    r, n = (2 if cfg.remat else 1), n_microbatches
    return {"rmsnorm": n * (R * r + 1 + Ro), "matmul": n * P * r,
            "flash_attention": n * F * r, "rmsnorm_bwd": n * (R + 1 + Ro),
            "matmul_bwd": 2 * n * P, "flash_attention_bwd": n * F}


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
    like the Mamba conv, scan and recurrence, is plain torch.  With a
    context (``lm.prefill(..., ctx_embeds)``, then ``lm.decode_step``; no
    engine takes one) a prefill adds :func:`_context_counts` (a
    cross-attention sublayer's norm, 4 products and flash attention; the
    encoder's 2 Le + 1 norms, 7 Le products and Le flash attentions), and
    a decode step a cross-attention sublayer's norm and 2 products (``wq``
    and ``wo``; its attention over the cached context is plain torch)."""
    A, *_, Xa = _sublayer_counts(cfg)
    R, P = _norms_and_products(cfg)
    Rc, Pc, Fc, Ro = _context_counts(cfg)
    fwd = prefills + decode_steps + chunks
    paged_fwd = chunks + (decode_steps if paged else 0)
    return {**{k: 0 for k in LAUNCHES},
            "rmsnorm": (R + Xa + 1) * fwd + (Rc + Ro - Xa) * prefills,
            "matmul": (P + 2 * Xa) * fwd + (Pc - 2 * Xa) * prefills,
            "flash_attention": (A + Fc) * prefills,
            "paged_attention": A * paged_fwd}


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig,
                     generator: torch.Generator, device="cuda") -> TrainState:
    """Random trainable weights for ``cfg`` (``generator`` on ``device``)
    and their fresh optimizer state."""
    params = trainable(init_params(lm.model_defs(cfg), generator, device))
    return TrainState(params, adamw_init(params, opt_cfg))
