"""The train step: microbatched gradient accumulation, then AdamW.

The port's counterpart of ``repro.train.trainer`` (``TrainState``,
``train_state_defs``, ``abstract_train_state``, ``train_state_shardings``,
``make_grad_sync``, ``make_train_step``, ``init_train_state``).  Gradients
come from ``torch.autograd.grad`` of ``lm.forward_train``, through the
kernels' backwards on the card; they are in each parameter's dtype, and
microbatches accumulate them in ``acc_dtype``.

Under a mesh (``rules``) the step is an explicit ZeRO-3 over the ``fsdp``
rule: the forward gathers each period's ``fsdp``-cut leaves before use
(``lm.trunk``), so their gradients come back reduce-scattered over the
data dimensions, and :func:`make_grad_sync` all-reduces the gradients of
the leaves whole over them (the embedding, head and norms), after the
backward or, bucketed, as the backward makes them.  Not FSDP2: the
reference cuts a stacked leaf's d_model (its dimension -2), not its
dimension 0, and the kernels take plain contiguous tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, XATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (ShardingRules, cut_axes,
                                           init_local_params, param_placements,
                                           rule_axes)
from repro_torch.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.launches import LAUNCHES
from .optimizer import OptConfig, adamw_init, adamw_update, opt_state_defs


class TrainState(NamedTuple):
    params: Any
    opt: Any


def train_state_defs(cfg: ModelConfig, opt_cfg: OptConfig):
    pdefs = lm.model_defs(cfg)
    return pdefs, opt_state_defs(pdefs, opt_cfg)


def abstract_train_state(cfg: ModelConfig, opt_cfg: OptConfig) -> TrainState:
    """The train state's skeleton: a ``PV`` (shape and dtype) a leaf, in
    the state's tree.  It is the template a checkpoint restore targets
    without drawing a single weight first (at full width a second copy of
    the state does not fit the card)."""
    return TrainState(*train_state_defs(cfg, opt_cfg))


def train_state_shardings(cfg: ModelConfig, opt_cfg: OptConfig,
                          rules: ShardingRules) -> TrainState:
    """The placement of every leaf of the train state under ``rules`` (the
    optimizer's leaves inherit their parameter's logical axes), a pure
    function of (config, rules)."""
    pdefs, odefs = train_state_defs(cfg, opt_cfg)
    return TrainState(param_placements(pdefs, rules),
                      param_placements(odefs, rules))


def trainable(params: dict) -> dict:
    """The same tensors, each a leaf that autograd gives a gradient."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def loss_and_grads(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   ctx: torch.Tensor | None = None,
                   rules: ShardingRules | None = None):
    """(loss, gradient tree) of ``lm.forward_train`` at ``params`` (with the
    context ``ctx`` for the encdec and vlm families).  Under a mesh, this
    rank's part of the gradient: the leaves whole over the data dimensions
    still want the sum over them (:func:`make_grad_sync`)."""
    loss = lm.forward_train(params, tokens, cfg, ctx, rules)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), tree_unflatten(params, grads)


class GradSync:
    """The gradient sync of a train step under ``rules``
    (:func:`make_grad_sync`).  Each leaf's gradient is summed over the
    ``batch`` rule's mesh dimensions that the leaf is not cut over (over
    the ones it is cut over, the backward of the forward's gather has
    reduce-scattered it already).  The leaves come in ``lm.model_defs``'
    key order, the order ``sharding.shard_tree`` places a tree in.

    Unbucketed, :meth:`reduce` all-reduces those leaves in order once the
    backward is done.  Bucketed (``bucket_mb``), the leaves that need a sum
    go in reverse parameter order, the order the backward makes them, into
    buckets of at most ``bucket_mb`` MiB (a bucket closes at a change of
    dtype or of dimensions, so that each is one flat buffer); a
    ``Tensor.register_hook`` on each leaf (``torch.autograd.grad`` fires no
    post-accumulate hook) notes its gradient, and the bucket's all-reduce
    is issued ``async_op=True`` once its last gradient exists.  The step
    waits on every bucket before the update."""

    def __init__(self, cfg: ModelConfig, rules: ShardingRules,
                 bucket_mb: float | None = None):
        self.rules = rules
        mesh = rules.mesh
        self.defs = lm.model_defs(cfg)
        dp = rule_axes(rules, "batch")
        self.axes = [tuple(a for a in dp if a not in cut_axes(spec, mesh))
                     for spec in tree_leaves(param_placements(self.defs, rules))]
        self.bucket_bytes = None if bucket_mb is None else int(bucket_mb * 2**20)

    def reduce(self, grads: list) -> list:
        """Every gradient summed over its leaf's dimensions, in leaf order."""
        mesh = self.rules.mesh
        return [comm.all_reduce_raw(g, ax, mesh) if ax else g
                for g, ax in zip(grads, self.axes)]

    def _buckets(self, leaves: list) -> list:
        out, cur, size = [], [], 0
        for i in reversed(range(len(leaves))):
            if not self.axes[i]:
                continue
            if cur and (leaves[i].dtype != leaves[cur[0]].dtype
                        or self.axes[i] != self.axes[cur[0]]):
                out.append(cur)
                cur, size = [], 0
            cur.append(i)
            size += leaves[i].numel() * leaves[i].element_size()
            if size >= self.bucket_bytes:
                out.append(cur)
                cur, size = [], 0
        return out + ([cur] if cur else [])

    def during_backward(self, leaves: list, final):
        """Hooks for one backward over ``leaves``: ``final(i, g)`` turns
        leaf i's gradient from this backward into its step gradient (the
        microbatches' mean); returns ``finish()``, which waits on the
        buckets and gives every leaf's step gradient, summed."""
        mesh = self.rules.mesh
        out: list = [None] * len(leaves)
        buckets = self._buckets(leaves)
        owner = {i: b for b, idx in enumerate(buckets) for i in idx}
        missing = [len(idx) for idx in buckets]
        inflight: dict = {}

        def hook(i):
            def fn(g):
                out[i] = final(i, g)
                b = owner.get(i)
                if b is not None:
                    missing[b] -= 1
                    if missing[b] == 0:             # the bucket's last gradient
                        flat = torch.cat([out[j].reshape(-1) for j in buckets[b]])
                        inflight[b] = comm.all_reduce_start(
                            flat, self.axes[buckets[b][0]], mesh)
                return g
            return fn

        handles = [t.register_hook(hook(i)) for i, t in enumerate(leaves)]

        def finish() -> list:
            for h in handles:
                h.remove()
            for b, idx in enumerate(buckets):
                flat = inflight[b].wait()
                for j, part in zip(idx, flat.split([out[j].numel() for j in idx])):
                    out[j] = part.view_as(out[j])
            return out
        return finish


def make_grad_sync(cfg: ModelConfig, rules: ShardingRules,
                   bucket_mb: float | None = None) -> GradSync:
    """The gradient sync hook of ``make_train_step(grad_sync=)``: unbucketed,
    or with ``bucket_mb`` bucketed and issued during the backward (the
    reference's ``fsdp_hier_ov`` variant); both give the same sums."""
    return GradSync(cfg, rules, bucket_mb)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    n_microbatches: int = 1, acc_dtype=torch.float32, *,
                    rules: ShardingRules | None = None,
                    grad_sync: GradSync | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: ``{"tokens": (B, S) int tensor}`` on the parameters' device, and
    for the encdec and vlm families ``"ctx"``, (B, T, d_ctx) f32.
    Microbatches split the batch dim (of both) in order and accumulate
    gradients in
    ``acc_dtype``; the gradient is their mean, and so is the loss.  The
    update is written into ``state``'s tensors in place (``adamw_update``);
    metrics are ``{"lr", "grad_norm", "loss"}``, 0-d f32 tensors.

    Under a mesh (``rules``) the state is this rank's blocks, the batch
    this rank's rows, the loss the whole batch's, and ``grad_sync``
    (:func:`make_grad_sync`, unbucketed by default) sums the gradients."""
    mesh = None if rules is None else rules.mesh
    if mesh is not None and not set(rule_axes(rules, "fsdp")) <= set(
            rule_axes(rules, "batch")):
        # a batch whole on the ranks of an fsdp dimension would have its
        # gradient summed once a rank by the gathers' reduce-scatters
        raise ValueError(f"the fsdp rule's dimensions {rule_axes(rules, 'fsdp')} "
                         f"must cut the batch too (batch rule "
                         f"{rule_axes(rules, 'batch')}): give a batch that divides")
    if mesh is not None and grad_sync is None:
        grad_sync = make_grad_sync(cfg, rules)
    pdefs = lm.model_defs(cfg) if mesh is not None else None

    def train_step(state: TrainState, batch):
        tokens = batch["tokens"]
        ctx = batch.get("ctx")
        B = tokens.shape[0]
        n = n_microbatches
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} microbatches")
        mb = B // n
        leaves = tree_leaves(state.params)
        acc = (None if n == 1 else
               [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                for p in leaves])

        def final(i, g):                    # a leaf's last gradient -> the mean
            if acc is None:
                return g
            acc[i].add_(g.to(acc_dtype))
            return acc[i] / n

        lsum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(n):
            rows = slice(i * mb, (i + 1) * mb)
            last = i == n - 1
            finish = (grad_sync.during_backward(leaves, final)
                      if last and grad_sync is not None
                      and grad_sync.bucket_bytes is not None else None)
            l, g = loss_and_grads(state.params, tokens[rows], cfg,
                                  None if ctx is None else ctx[rows], rules)
            lsum = lsum + l
            g = tree_leaves(g)
            if finish is not None:
                grads = finish()
            elif last:
                grads = [final(j, gj) for j, gj in enumerate(g)]
                if grad_sync is not None:
                    grads = grad_sync.reduce(grads)
            else:
                for a, gj in zip(acc, g):
                    a.add_(gj.to(acc_dtype))
            del g
        grads = tree_unflatten(state.params, grads)
        loss = lsum if n == 1 else lsum / n
        params, opt, metrics = adamw_update(state.params, grads, state.opt,
                                            opt_cfg, rules, pdefs)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step


def _sublayer_counts(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    """(A, M, X, S, Xa): the model's self-attention, MLP, MoE, Mamba and
    cross-attention sublayers."""
    kinds = [k for layer in cfg.layer_period for k in layer]
    return tuple(kinds.count(k) * cfg.n_periods
                 for k in (ATTN, MLP, MOE, MAMBA, XATTN))


def _experts_run(cfg: ModelConfig, rules: ShardingRules | None) -> int:
    """The experts a MoE sublayer runs on one rank: all of them off-mesh
    and in "tp" mode, E/|model| in "ep" and "ep_a2a"."""
    if L.moe_mode(cfg, rules) in ("local", "tp"):
        return cfg.n_experts
    return cfg.n_experts // L._model_size(rules)


def _norms_and_products(cfg: ModelConfig, rules: ShardingRules | None = None
                        ) -> tuple[int, int]:
    """A forward's rmsnorms and matmul launches in the layer periods, the
    cross-attention sublayers left out (R and P): one norm a self-attention,
    MLP or MoE sublayer and two a Mamba one (its input and its gated
    output); 4 projections an attention, 3 an MLP, 3 for each of the E
    experts a MoE (every expert runs on its C buffer rows, tokens or none;
    under a mesh each of the rank's experts, :func:`_experts_run`) and 2 a
    Mamba (``in_proj``, ``out_proj``).  Where a mesh cuts the Mamba heads
    over `model`, its gated norm sums its squares over `model` in plain
    torch (``layers._gated_norm``): one norm a Mamba sublayer.  Otherwise a
    mesh cuts the shapes, not the calls: the rest holds on every rank."""
    A, M, X, S, _ = _sublayer_counts(cfg)
    E = _experts_run(cfg, rules) if X else 0
    Sn = S if L._model_size(rules) > 1 else 2 * S
    return A + M + X + Sn, 4 * A + 3 * M + 3 * E * X + 2 * S


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


def step_launches(cfg: ModelConfig, n_microbatches: int = 1,
                  rules: ShardingRules | None = None) -> dict:
    """The kernel launches of one train step on the card, by counter (on
    one rank under the mesh of ``rules``).

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
    R, P = _norms_and_products(cfg, rules)
    Rc, Pc, Fc, Ro = _context_counts(cfg)
    R, P, F = R + Rc, P + Pc, A + Fc
    r, n = (2 if cfg.remat else 1), n_microbatches
    return {"rmsnorm": n * (R * r + 1 + Ro), "matmul": n * P * r,
            "flash_attention": n * F * r, "rmsnorm_bwd": n * (R + 1 + Ro),
            "matmul_bwd": 2 * n * P, "flash_attention_bwd": n * F}


def serve_launches(cfg: ModelConfig, prefills: int = 0, decode_steps: int = 0,
                   *, chunks: int = 0, paged: bool = False,
                   rules: ShardingRules | None = None) -> dict:
    """The kernel launches of a serving run on the card (on one rank under
    the mesh of ``rules``), by counter, from
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
    R, P = _norms_and_products(cfg, rules)
    Rc, Pc, Fc, Ro = _context_counts(cfg)
    fwd = prefills + decode_steps + chunks
    paged_fwd = chunks + (decode_steps if paged else 0)
    return {**{k: 0 for k in LAUNCHES},
            "rmsnorm": (R + Xa + 1) * fwd + (Rc + Ro - Xa) * prefills,
            "matmul": (P + 2 * Xa) * fwd + (Pc - 2 * Xa) * prefills,
            "flash_attention": (A + Fc) * prefills,
            "paged_attention": A * paged_fwd}


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig,
                     generator: torch.Generator, device="cuda",
                     rules: ShardingRules | None = None) -> TrainState:
    """Random trainable weights for ``cfg`` (``generator`` on ``device``;
    under a mesh this rank's blocks of the same whole draw) and their fresh
    optimizer state."""
    params = trainable(init_local_params(lm.model_defs(cfg), rules or
                                         ShardingRules(), generator, device))
    return TrainState(params, adamw_init(params, opt_cfg))
