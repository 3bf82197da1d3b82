"""Whole-model assembly: embeddings -> layer periods -> head.

The port's counterpart of ``repro.models.lm``, every family of it:

    dense / moe      decoder-only periods of (attn, mlp|moe)
    ssm              (mamba,) periods
    hybrid (jamba)   8-layer periods mixing mamba/attn and moe/mlp
    encdec           + a bidirectional encoder; decoder layers carry xattn
    vlm              + a frontend projection; xattn layers attend image tokens

``forward_train`` gives the mean next-token cross-entropy, which autograd
differentiates through the kernels' backwards; ``prefill`` populates the
caches (K/V, each Mamba sublayer's conv window and SSM state, each
cross-attention sublayer's projected context) and returns the last
token's logits; ``decode_step`` advances every slot by one token;
``decode_step_paged`` and ``prefill_chunk`` do the same against a paged
block pool (``pool_defs``: attention caches only, so not for a period with
Mamba or cross-attention).  The encdec and vlm families take the context
(``ctx_embeds``, (B, T, d_ctx)) in ``forward_train`` and ``prefill``;
``encode_context`` projects it (and runs the encoder).  A MoE sublayer sees
every row of a call.  A Python loop over ``n_periods`` replaces
``lax.scan``; the param tree keeps JAX's nesting, each period leaf stacked
over ``n_periods``.

``rules`` (a keyword of ``trunk``, ``forward_train``, ``prefill`` and
``decode_step``; no mesh by default) runs the model on a process mesh:
each rank passes its blocks of the weights (``parallel.sharding``) and its
rows of the batch (cut over the ``batch`` rule's dimensions).  The
embedding and the head are cut over `model` on the vocabulary: the lookup
is a masked local gather and a psum, the loss a vocab-parallel
cross-entropy (pmax and psum of the exp-sums over `model`, the target's
logit from the rank that holds it), divided by the global mask sum, and
``prefill``'s and ``decode_step``'s logits are gathered whole.  Each
period's leaves cut over the ``fsdp`` rule are gathered before use (again
in the remat recompute), so their gradients come back reduce-scattered;
so are the encoder layers' and ``ctx_proj``, whose context (this rank's
rows, as the tokens) the encoder runs tensor-parallel.  The paged path
(``decode_step_paged``, ``prefill_chunk``) takes ``rules`` too: the pool
holds a rank's kv heads (``pool_defs``' ``kv`` cut).
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ATTN, MAMBA, MLP, MOE, XATTN, ModelConfig
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import ShardingRules, param_placements, rule_axes
from repro_torch.params import PV, ParamTree, tree_leaves, tree_map
from . import layers as L

#: the families whose decoder attends to a context
CONTEXT_FAMILIES = ("encdec", "vlm")


# ---------------------------------------------------------------------------
# Parameter and cache definitions
# ---------------------------------------------------------------------------

def _stack(defs: dict, n: int) -> dict:
    return tree_map(lambda pv: PV((n,) + pv.shape, pv.dtype, ("",) + pv.logical,
                                  pv.init, pv.scale), defs)


def _sublayer_defs(kind: str, cfg: ModelConfig) -> dict:
    if kind == ATTN:
        return L.attn_defs(cfg)
    if kind == MLP:
        return L.mlp_defs(cfg)
    if kind == MOE:
        return L.moe_defs_tp(cfg) if cfg.moe_tp else L.moe_defs(cfg)
    if kind == MAMBA:
        return L.mamba_defs(cfg)
    if kind == XATTN:
        return L.xattn_defs(cfg)
    raise ValueError(kind)


def model_defs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    Vp = cfg.padded_vocab
    defs: dict[str, Any] = {
        "embed": PV((Vp, d), dt, ("model", ""), "normal", 0.02),
        "final_norm": PV((d,), torch.float32, ("",), "ones"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = PV((d, Vp), dt, ("", "model"))
    period = {}
    for li, layer in enumerate(cfg.layer_period):
        period[f"l{li}"] = {f"s{si}_{kind}": _stack(_sublayer_defs(kind, cfg),
                                                   cfg.n_periods)
                            for si, kind in enumerate(layer)}
    defs["period"] = period
    if cfg.family == "encdec":
        enc_layer = {"attn": L.attn_defs(cfg), "mlp": L.mlp_defs(cfg)}
        defs["encoder"] = {"layers": _stack(enc_layer, cfg.n_enc_layers),
                           "norm": PV((d,), torch.float32, ("",), "ones")}
    if cfg.d_ctx:
        defs["ctx_proj"] = PV((cfg.d_ctx, d), dt, ("", "fsdp"))
    return defs


def cache_defs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    period = {}
    for li, layer in enumerate(cfg.layer_period):
        slots = {}
        for si, kind in enumerate(layer):
            if kind == ATTN:
                slots[f"s{si}_{kind}"] = _stack(
                    L.attn_cache_defs(cfg, batch, seq_len)._asdict(),
                    cfg.n_periods)
            elif kind == XATTN:
                slots[f"s{si}_{kind}"] = _stack(
                    L.xattn_cache_defs(cfg, batch)._asdict(), cfg.n_periods)
            elif kind == MAMBA:
                slots[f"s{si}_{kind}"] = _stack(
                    L.mamba_cache_defs(cfg, batch)._asdict(), cfg.n_periods)
        period[f"l{li}"] = slots
    return period


def pool_defs(cfg: ModelConfig, n_blocks: int, block_tokens: int) -> dict:
    """Paged-KV block pool defs: the tree of :func:`cache_defs` with each
    ATTN leaf (n_periods, n_blocks, block_tokens, Hkv, Dh), a shared pool of
    fixed-size token blocks indexed by per-request block tables (block 0 is
    the reserved zero block).  Attention caches only (a Mamba or
    cross-attention sublayer raises, with the reference's message), and full
    attention (no SWA ring)."""
    if cfg.window:
        raise ValueError("paged KV supports full attention only "
                         f"(cfg.window={cfg.window})")
    shp = (n_blocks, block_tokens, cfg.n_kv_heads, cfg.head_dim)
    period = {}
    for li, layer in enumerate(cfg.layer_period):
        slots = {}
        for si, kind in enumerate(layer):
            if kind == ATTN:
                slots[f"s{si}_{kind}"] = _stack(
                    {"k": PV(shp, cfg.dtype, ("", "", "kv", ""), "zeros"),
                     "v": PV(shp, cfg.dtype, ("", "", "kv", ""), "zeros")},
                    cfg.n_periods)
            elif kind in (XATTN, MAMBA):
                raise ValueError(f"paged KV serving supports attention caches "
                                 f"only, layer period has {kind}")
        period[f"l{li}"] = slots
    return period


class Model(ParamTree):
    """A model's weights as an ``nn.Module``: ``state_dict`` keys are the
    JAX tree's dotted paths (``period.l0.s0_attn.wq``).  Its leaves are
    frozen, as serving wants."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg


# ---------------------------------------------------------------------------
# Embedding and head
# ---------------------------------------------------------------------------

def _vocab_axes(rules) -> tuple:
    """The mesh dimensions the vocabulary of the embedding (and so of the
    head) is cut over, ``()`` off-mesh."""
    if rules is None or rules.mesh is None:
        return ()
    return rules.spec(("model", ""))[0]


def _batch_axes(rules) -> tuple:
    return () if rules is None else rule_axes(rules, "batch")


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 rules: ShardingRules | None = None) -> torch.Tensor:
    """The embedding rows of ``tokens``.  With the vocabulary cut over
    `model`: each rank gathers the rows it holds (zeros elsewhere) and a
    psum over `model` completes them (the reference's explicit lookup).

    The lookup is ``F.embedding``, not ``embed[tokens]``: on the CPU the
    backward of an advanced index is ``index_put_(accumulate=True)``,
    whose threads add a repeated token's rows by atomic float adds in the
    order they happen to run, so the gradient changed bits from run to
    run; ``F.embedding``'s backward sums them in one fixed order."""
    axes = _vocab_axes(rules)
    if not axes:
        return F.embedding(tokens, params["embed"])
    emb = params["embed"]
    V_loc = emb.shape[0]
    ids = tokens - comm.axis_index(axes, rules.mesh) * V_loc
    ok = (ids >= 0) & (ids < V_loc)
    x = torch.where(ok[..., None], F.embedding(ids.clamp(0, V_loc - 1), emb), 0)
    return comm.psum(x, axes, rules.mesh)


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig, lo: int = 0
                    ) -> torch.Tensor:
    """-1e30 at the padded ids (of the columns ``lo``, ``lo`` + 1, ...)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = lo + torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(ids >= cfg.vocab_size, -1e30)


def _head(params, x: torch.Tensor, cfg: ModelConfig, rules) -> tuple:
    """The head's product of the normed x, on this rank's vocabulary
    columns under a mesh: (logits, first column id, vocab dimensions)."""
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    axes = _vocab_axes(rules)
    if not axes:
        return _mask_pad_vocab(torch.matmul(x, head), cfg), 0, axes
    lo = comm.axis_index(axes, rules.mesh) * head.shape[1]
    x = comm.copy_to_group(x, axes, rules.mesh)
    return _mask_pad_vocab(torch.matmul(x, head), cfg, lo), lo, axes


def logits_fn(params, x: torch.Tensor, cfg: ModelConfig,
              rules: ShardingRules | None = None) -> torch.Tensor:
    """Every vocabulary column's logit (gathered over `model` under a
    mesh); the head is a plain product, as in the JAX model (XLA's, not a
    Pallas kernel)."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits, _, axes = _head(params, x, cfg, rules)
    return comm.gather(logits, axes, rules.mesh, dim=-1) if axes else logits


# ---------------------------------------------------------------------------
# Context (encoder / image frontend)
# ---------------------------------------------------------------------------

def context_len(cfg: ModelConfig, seq_len: int) -> int:
    """Context tokens a sample carries: speech frames downsampled 4x from
    the text length (encdec, at least ``ssm_chunk``), else the config's."""
    if cfg.family == "encdec":
        return max(cfg.ssm_chunk, seq_len // 4)
    return cfg.n_ctx_tokens


def _encoder_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, rules=None, specs=None) -> torch.Tensor:
    lp = _fsdp_gather(lp, specs, rules)
    x = L.attn_layer(lp["attn"], x, cfg, positions, causal=False, rules=rules)
    return L.mlp_layer(lp["mlp"], x, cfg, rules=rules)


def _placements_of(cfg: ModelConfig, rules, *path) -> Any:
    """The placements of the ``model_defs`` subtree at ``path`` under
    ``rules``, None off-mesh."""
    if rules is None or rules.mesh is None:
        return None
    defs = model_defs(cfg)
    for k in path:
        defs = defs[k]
    return param_placements(defs, rules)


def encode_context(params, ctx_embeds: torch.Tensor, cfg: ModelConfig,
                   rules: ShardingRules | None = None) -> torch.Tensor:
    """The frontend's embeddings (B, T, d_ctx) -> the d_model context that
    the cross-attention sublayers read: cast to the model dtype, through
    ``ctx_proj`` (a plain ``torch.matmul``, as the reference's ``@`` is
    XLA's), then for encdec the bidirectional encoder (RoPE at positions
    0..T-1, each layer one ``torch.utils.checkpoint`` under ``cfg.remat``)
    and its final rmsnorm, outside the checkpoints.  Under a mesh
    ``ctx_proj`` and each encoder layer are gathered over the ``fsdp``
    rule's dimensions first, and the encoder runs tensor-parallel."""
    ctx = ctx_embeds.to(cfg.dtype)
    if "ctx_proj" in params:
        w = params["ctx_proj"]
        spec = _placements_of(cfg, rules, "ctx_proj")
        if spec is not None:
            w = _fsdp_gather({"w": w}, {"w": spec}, rules)["w"]
        ctx = torch.matmul(ctx, w)
    if cfg.family != "encdec":
        return ctx
    enc = params["encoder"]
    specs = _placements_of(cfg, rules, "encoder", "layers")
    if specs is not None:
        specs = tree_map(lambda s: s[1:], specs)
    positions = torch.arange(ctx.shape[1], device=ctx.device)
    body = functools.partial(_encoder_layer, cfg=cfg, positions=positions,
                             rules=rules, specs=specs)
    for lp in _unstack(enc["layers"], cfg.n_enc_layers):
        ctx = _remat(cfg, body, lp, ctx)
    return L.rmsnorm(ctx, enc["norm"], cfg.norm_eps)


def _context(params, ctx_embeds, cfg: ModelConfig, rules=None):
    """``encode_context`` for the families that take a context, else None;
    such a family without ``ctx_embeds`` raises."""
    if cfg.family not in CONTEXT_FAMILIES:
        return None
    if ctx_embeds is None:
        raise ValueError(f"{cfg.name} is a {cfg.family} model: it needs "
                         f"ctx_embeds (B, T, d_ctx = {cfg.d_ctx})")
    return encode_context(params, ctx_embeds, cfg, rules)


# ---------------------------------------------------------------------------
# Training: trunk, loss
# ---------------------------------------------------------------------------

def _remat(cfg: ModelConfig, body, *args):
    """``body(*args)``, under ``cfg.remat`` (where autograd records) as one
    non-reentrant ``torch.utils.checkpoint``, as ``jax.checkpoint`` of the
    JAX body: its activations are recomputed in the backward, so each of
    its forward kernels launches once more (early stop off: the count does
    not depend on which tensor autograd asks for last)."""
    if cfg.remat and torch.is_grad_enabled():
        with _ckpt.set_checkpoint_early_stop(False):
            return _ckpt.checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def _unstack(tree: dict, n: int) -> list:
    """The n period slices of a stacked tree, by one ``unbind`` a leaf: its
    gradient is one stack of the n slices' gradients, not n full-size
    buffers (``t[i]`` would scatter each slice's into a zero leaf)."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p: p[i], parts) for i in range(n)]


def _apply_slot(kind: str, sp: dict, x: torch.Tensor, cfg: ModelConfig,
                positions, ctx, rules=None) -> torch.Tensor:
    if kind == ATTN:
        return L.attn_layer(sp, x, cfg, positions, causal=True, rules=rules)
    if kind == XATTN:
        return L.xattn_layer(sp, x, ctx, cfg, rules=rules)
    if kind == MLP:
        return L.mlp_layer(sp, x, cfg, rules=rules)
    if kind == MOE:
        return L.moe_layer(sp, x, cfg, rules=rules)
    if kind == MAMBA:
        return L.mamba_layer(sp, x, cfg, rules=rules)
    raise ValueError(kind)


def _period_specs(cfg: ModelConfig, rules) -> dict | None:
    """The placements of one period's leaves (the stacked leaves' specs
    without their whole period dimension), None off-mesh."""
    specs = _placements_of(cfg, rules, "period")
    return None if specs is None else tree_map(lambda s: s[1:], specs)


def _fsdp_gather(pp: dict, specs: dict | None, rules) -> dict:
    """One period's blocks with every dimension cut over the ``fsdp``
    rule's mesh dimensions gathered whole (an ``all_gather``: its backward
    reduce-scatters the gradient over them)."""
    fsdp = set(rule_axes(rules, "fsdp")) if specs is not None else set()
    if not fsdp:
        return pp

    def one(t, spec):
        for d, axes in enumerate(spec):
            if axes and set(axes) <= fsdp:
                t = comm.all_gather(t, axes, rules.mesh, dim=d)
            elif set(axes) & fsdp:
                raise ValueError(f"a dimension cut over {axes}: the fsdp "
                                 f"rule's {sorted(fsdp)} and others at once")
        return t

    def walk(p, s):
        return {k: walk(v, s[k]) for k, v in p.items()} if isinstance(p, dict) \
            else one(p, s)
    return walk(pp, specs)


def _apply_period(pp: dict, x: torch.Tensor, ctx, cfg: ModelConfig,
                  positions: torch.Tensor, rules=None, specs=None) -> torch.Tensor:
    pp = _fsdp_gather(pp, specs, rules)
    for li, layer in enumerate(cfg.layer_period):
        for si, kind in enumerate(layer):
            x = _apply_slot(kind, pp[f"l{li}"][f"s{si}_{kind}"], x, cfg,
                            positions, ctx, rules)
    return x


def trunk(params, x: torch.Tensor, cfg: ModelConfig,
          positions: torch.Tensor, ctx: torch.Tensor | None = None,
          rules: ShardingRules | None = None) -> torch.Tensor:
    """The layer periods in order, the cross-attention sublayers reading
    ``ctx``.  With ``cfg.remat`` each period is one checkpoint
    (:func:`_remat`), ``ctx`` among its arguments, so that its gradient
    reaches the encoder and ``ctx_proj``; under a mesh the period's
    ``fsdp``-cut leaves are gathered inside it."""
    specs = _period_specs(cfg, rules)
    for pp in _unstack(params["period"], cfg.n_periods):
        body = functools.partial(_apply_period, pp, cfg=cfg, positions=positions,
                                 rules=rules, specs=specs)
        x = _remat(cfg, body, x, ctx)
    return x


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE, ``logsumexp - picked``, in f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, targets[..., None].long())[..., 0]
    return lse - picked


def _ce_terms_vp(logits: torch.Tensor, targets: torch.Tensor, lo: int,
                 axes: tuple, mesh) -> torch.Tensor:
    """``_ce_terms`` over logits whose vocabulary is cut over ``axes``
    (this rank's columns from ``lo``): the max and the exp-sum psummed (the
    max carries no gradient: it cancels in logsumexp), and the target's
    logit from the rank that holds it."""
    lf = logits.float()
    m = comm.pmax(torch.amax(lf, dim=-1, keepdim=True), axes, mesh)
    se = comm.psum(torch.sum(torch.exp(lf - m), dim=-1), axes, mesh)
    lse = torch.log(se) + m[..., 0]
    t = targets.long() - lo
    ok = (t >= 0) & (t < lf.shape[-1])
    picked = torch.gather(lf, -1, t.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
    return lse - comm.psum(torch.where(ok, picked, 0.0), axes, mesh)


def ce_loss(params, x: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
            cfg: ModelConfig, rules: ShardingRules | None = None) -> torch.Tensor:
    """Mean masked next-token CE.  With ``cfg.loss_chunk`` dividing S the
    sequence goes in checkpointed blocks, so the f32 logits (B, S, V) are
    never whole; the head stays ``torch.matmul``, as the JAX model leaves
    ``x @ head`` to XLA.  Under a mesh x holds this rank's rows, the
    cross-entropy is vocab-parallel, and the masked sum is divided by the
    mask's sum over every rank's rows (the batch's, not a mean of means)."""
    B, S, _ = x.shape
    mesh = None if rules is None else rules.mesh
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)

    def block(xc, tc, mc):
        logits, lo, axes = _head(params, xc, cfg, rules)
        terms = (_ce_terms_vp(logits, tc, lo, axes, mesh) if axes
                 else _ce_terms(logits, tc))
        return torch.sum(terms * mc)

    chunk = cfg.loss_chunk
    if chunk <= 0 or S <= chunk or S % chunk:
        total = block(x, targets, mask)
    else:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            args = (x[:, sl], targets[:, sl], mask[:, sl])
            total = total + (_ckpt.checkpoint(block, *args, use_reentrant=False)
                             if torch.is_grad_enabled() else block(*args))
    bax = _batch_axes(rules)
    if bax:
        return comm.psum(total, bax, mesh) / comm.psum(torch.sum(mask), bax, mesh)
    return total / torch.sum(mask)


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig,
                  ctx_embeds: torch.Tensor | None = None,
                  rules: ShardingRules | None = None) -> torch.Tensor:
    """tokens (B, S) (and, for encdec and vlm, ctx_embeds (B, T, d_ctx))
    -> the mean next-token cross-entropy (a 0-d f32 tensor); targets are
    the tokens shifted left by one, wrapped, and the last position is
    masked out.  Under a mesh, tokens are this rank's rows and the loss is
    the whole batch's."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    ctx = _context(params, ctx_embeds, cfg, rules)
    x = embed_tokens(params, tokens, cfg, rules)
    x = trunk(params, x, cfg, positions, ctx, rules)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return ce_loss(params, x, targets, mask, cfg, rules)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _period(tree: dict, i: int) -> dict:
    return tree_map(lambda t: t[i], tree)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, cache_seq_len: int,
            ctx_embeds: torch.Tensor | None = None,
            rules: ShardingRules | None = None):
    """tokens (B, S) (and, for encdec and vlm, ctx_embeds (B, T, d_ctx))
    -> (cache, last-token logits (B, 1, V)).  A cross-attention sublayer's
    cache is its projected context, (B, T, Hkv, Dh) K and V.  Under a mesh
    the cache is this rank's block (``layers.attn_layer_prefill``)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    ctx = _context(params, ctx_embeds, cfg, rules)
    x = embed_tokens(params, tokens, cfg, rules)
    W = L.attn_cache_len(cfg, cache_seq_len)
    specs = _period_specs(cfg, rules)
    per_period = []
    for i in range(cfg.n_periods):
        pp = _fsdp_gather(_period(params["period"], i), specs, rules)
        caches = {}
        for li, layer in enumerate(cfg.layer_period):
            lcaches = {}
            for si, kind in enumerate(layer):
                key = f"s{si}_{kind}"
                sp = pp[f"l{li}"][key]
                if kind == ATTN:
                    x, c = L.attn_layer_prefill(sp, x, cfg, positions, W,
                                                rules=rules)
                    lcaches[key] = c._asdict()
                elif kind == XATTN:
                    x, c = L.xattn_layer_prefill(sp, x, ctx, cfg, rules=rules)
                    lcaches[key] = c._asdict()
                elif kind == MAMBA:
                    x, (conv, state) = L.mamba_layer(sp, x, cfg,
                                                     return_state=True,
                                                     rules=rules)
                    lcaches[key] = {"conv": conv.to(cfg.dtype), "state": state}
                else:
                    x = _apply_slot(kind, sp, x, cfg, positions, ctx, rules)
            caches[f"l{li}"] = lcaches
        per_period.append(caches)
    logits = logits_fn(params, x[:, -1:], cfg, rules)
    return _stack_trees(per_period), logits


def _stack_trees(trees: list):
    """Stack same-shaped trees leaf by leaf along a new leading dim."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def decode_step(params, token: torch.Tensor, cache: dict, pos,
                cfg: ModelConfig, rules: ShardingRules | None = None):
    """token (B, 1), pos a scalar or (B,) per-slot positions -> (logits
    (B, 1, V), cache).  The cache is updated in place and returned (under
    a mesh, this rank's block of it)."""
    x = embed_tokens(params, token, cfg, rules)
    specs = _period_specs(cfg, rules)
    for i in range(cfg.n_periods):
        pp = _fsdp_gather(_period(params["period"], i), specs, rules)
        cc = _period(cache, i)              # views: decode writes land in cache
        for li, layer in enumerate(cfg.layer_period):
            for si, kind in enumerate(layer):
                key = f"s{si}_{kind}"
                sp = pp[f"l{li}"][key]
                if kind == ATTN:
                    c = L.AttnCache(**cc[f"l{li}"][key])
                    x, _ = L.attn_layer_decode(sp, x, c, pos, cfg, rules=rules)
                elif kind == XATTN:
                    c = L.XAttnCache(**cc[f"l{li}"][key])
                    x, _ = L.xattn_layer_decode(sp, x, c, cfg, rules=rules)
                elif kind == MAMBA:
                    c = L.MambaCache(**cc[f"l{li}"][key])
                    x, _ = L.mamba_layer_decode(sp, x, c, cfg, rules=rules)
                else:
                    x = _apply_slot(kind, sp, x, cfg, None, None, rules)
    logits = logits_fn(params, x, cfg, rules)
    return logits, cache


def _paged_forward(params, x: torch.Tensor, pool: dict, pb: L.PagedBatch,
                   cfg: ModelConfig, rules=None) -> torch.Tensor:
    """The layer periods over a paged pool, written in place."""
    specs = _period_specs(cfg, rules)
    for i in range(cfg.n_periods):
        pp = _fsdp_gather(_period(params["period"], i), specs, rules)
        cc = _period(pool, i)               # views: pool writes land in pool
        for li, layer in enumerate(cfg.layer_period):
            for si, kind in enumerate(layer):
                key = f"s{si}_{kind}"
                sp = pp[f"l{li}"][key]
                if kind == ATTN:
                    c = cc[f"l{li}"][key]
                    x = L.attn_layer_paged(sp, x, c["k"], c["v"], pb, cfg, rules)
                elif kind in (MLP, MOE):
                    x = _apply_slot(kind, sp, x, cfg, None, None, rules)
                else:                       # pool_defs refuses these periods
                    raise ValueError(f"paged KV serving supports attention "
                                     f"caches only, layer period has {kind}")
    return x


def _block_tokens(pool: dict) -> int:
    return tree_leaves(pool)[0].shape[2]


def decode_step_paged(params, token: torch.Tensor, pool: dict, tables, pos,
                      live, cfg: ModelConfig, rules: ShardingRules | None = None):
    """One-token decode through block tables: token (B, 1); pool the
    :func:`pool_defs` tree; tables (B, max_blocks); pos (B,) per-slot
    positions; live (B,) bool -> (logits (B, 1, V), pool).  tables, pos and
    live may be host arrays: they go to the card once per step.  The pool
    is updated in place (live slots only) and returned (under a mesh this
    rank's kv heads of it)."""
    pb = L.decode_batch(tables, pos, live, _block_tokens(pool), token.device)
    x = embed_tokens(params, token, cfg, rules)
    x = _paged_forward(params, x, pool, pb, cfg, rules)
    return logits_fn(params, x, cfg, rules), pool


def prefill_chunk(params, tokens: torch.Tensor, pool: dict, table_row,
                  start: int, valid: int, cfg: ModelConfig,
                  rules: ShardingRules | None = None):
    """One fixed-size prefill chunk for a single request: tokens (1, c)
    padded to the chunk length, ``start`` the chunk's base position (a
    multiple of the block size), ``valid`` the count of real tokens.  Writes
    the chunk's K/V into the allocated blocks of ``table_row`` in place and
    returns (logits (1, c, V) of every row, pool); the engine reads
    logits[0, valid - 1] on the final chunk for the first generated token."""
    c = tokens.shape[1]
    pb = L.chunk_batch(table_row, int(start), int(valid), c,
                       _block_tokens(pool), tokens.device)
    x = embed_tokens(params, tokens, cfg, rules)
    x = _paged_forward(params, x, pool, pb, cfg, rules)
    return logits_fn(params, x, cfg, rules), pool
