"""The cross-attention families (encdec: seamless-m4t-large-v2; vlm:
llama-3.2-vision-11b) serving through the port against the JAX package
(CPU, f32 smoke configs, the JAX initialiser's weights carried over by
``params_from_jax``, tokens and contexts from a numpy seed): the
cross-attention sublayer and its one-token step, ``encode_context`` (the
frontend projection, and the encoder), ``prefill(ctx_embeds)``'s logits and
caches, decode steps, greedy streams, decode against the whole-prompt
forward, the parameter and cache trees and counts, and the launch counts of
prefill and decode.  The engines' refusal is in ``test_torch_moe.py``;
training is ``test_torch_xattn_train.py``.

Tolerances (f32 on both sides; the products and the softmax sums run in
other orders, so no output is the same bits across the two frameworks):
  * a sublayer, the context and a decode step: ``|d| <= 1e-5 + 1e-5
    |want|``;
  * logits through whole models and the caches: ``|d| <= 1e-4 + 1e-4
    |want|`` (the smoke models' logits are of order 1);
  * decode against the forward inside the port: ``2e-3``, as the dense
    family's test (``tests/test_torch_moe.py``).
Contexts and prompts stay below 4,096 elements a RoPE call (the CPU's MKL
first-call hazard, ROADMAP Queue 3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules, init_params as jax_init
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.params import params_from_jax
from repro_torch.train import trainer
from test_torch_ssm_train import _serve_counting
from torch_jax_smoke import _paths

RULES = default_rules(None)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
XATTN = ["seamless-m4t-large-v2", "llama-3.2-vision-11b"]
#: the cross-attention sublayer of each arch's period: (layer, slot key)
XSLOT = {"seamless-m4t-large-v2": ("l0", "s1_xattn"),
         "llama-3.2-vision-11b": ("l2", "s0_xattn")}


def _setup(name, **over):
    jcfg = dataclasses.replace(jax_smoke_config(name), **over)
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _context(cfg, B, S, seed=0):
    """Frontend embeddings (B, context_len(S), d_ctx) f32 at the launcher's
    scale."""
    T = lm.context_len(cfg, S)
    return (np.random.default_rng(seed).normal(size=(B, T, cfg.d_ctx)) * 0.1
            ).astype(np.float32)


def _slot(name, jp, tp, i=0):
    li, key = XSLOT[name]
    return (jax.tree.map(lambda t: t[i], jp["period"][li][key]),
            {k: t[i] for k, t in tp["period"][li][key].items()})


@pytest.mark.parametrize("T", [1, 16, 37])
@pytest.mark.parametrize("name", XATTN)
def test_xattn_layer_matches_jax(name, T):
    """Queries of 9 tokens against contexts of 1, 16 and 37 tokens (fewer
    and more keys than queries)."""
    jcfg, cfg, jp, tp = _setup(name)
    jsp, sp = _slot(name, jp, tp)
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    ctx = rng.normal(size=(2, T, cfg.d_model)).astype(np.float32)
    want = JL.xattn_layer(jsp, jnp.asarray(x), jnp.asarray(ctx), jcfg, RULES)
    got = L.xattn_layer(sp, torch.from_numpy(x), torch.from_numpy(ctx), cfg)
    _close(got, want)
    # made once in prefill: the sublayer's output and the reference's cache
    got_p, kv = L.xattn_layer_prefill(sp, torch.from_numpy(x), torch.from_numpy(ctx), cfg)
    assert torch.equal(got_p, got)
    jkv = JL.xattn_prefill_cache(jsp, jnp.asarray(ctx), jcfg)
    for a, b in zip(kv, jkv):
        _close(a, b)


@pytest.mark.parametrize("name", XATTN)
def test_xattn_layer_decode_matches_jax(name):
    """A batch-3 step against a cached context of 21 tokens; the cache comes
    back unchanged."""
    jcfg, cfg, jp, tp = _setup(name)
    jsp, sp = _slot(name, jp, tp)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(3, 21, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
            for _ in range(2))
    jy, _ = JL.xattn_layer_decode(jsp, jnp.asarray(x),
                                  JL.XAttnCache(jnp.asarray(k), jnp.asarray(v)),
                                  jcfg, RULES)
    cache = L.XAttnCache(torch.from_numpy(k), torch.from_numpy(v))
    y, back = L.xattn_layer_decode(sp, torch.from_numpy(x), cache, cfg)
    _close(y, jy)
    assert back is cache and np.array_equal(back.k.numpy(), k)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", XATTN)
def test_encode_context_matches_jax(name, remat):
    """vlm: the frontend projection alone; encdec: the projection, the
    bidirectional encoder (its RoPE at positions 0..T-1) and its final
    norm, with and without remat (the checkpoint recomputes, it does not
    change the forward)."""
    jcfg, cfg, jp, tp = _setup(name, remat=remat)
    ctx = _context(cfg, 2, 48)
    want = jlm.encode_context(jp, jnp.asarray(ctx), jcfg, RULES)
    with torch.enable_grad():
        got = lm.encode_context(tp, torch.from_numpy(ctx), cfg)
    _close(got, want)
    assert got.shape == (2, ctx.shape[1], cfg.d_model)


def _prefill_pair(name, S=20, B=2, cache_len=32):
    jcfg, cfg, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    ctx = _context(cfg, B, S, seed=1)
    jc, jl = jlm.prefill(jp, jnp.asarray(toks), jcfg, RULES, cache_len,
                         ctx_embeds=jnp.asarray(ctx))
    tcache, tl = lm.prefill(tp, torch.from_numpy(toks).long(), cfg, cache_len,
                            torch.from_numpy(ctx))
    return (jcfg, cfg, jp, tp), (jc, jl), (tcache, tl), rng


@pytest.mark.parametrize("name", XATTN)
def test_prefill_logits_and_caches_match_jax(name):
    """A 20-token prompt with its context: the last logits and every cache
    leaf (self-attention K/V, and each cross-attention sublayer's projected
    context, (B, T, Hkv, Dh))."""
    (_, cfg, _, _), (jc, jl), (tcache, tl), _ = _prefill_pair(name)
    _close(tl, jl, LOGIT_TOL)
    want = dict(_paths(jax.tree.map(np.asarray, jc)))
    got = dict(_paths(tcache))
    assert set(got) == set(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        _close(t, want[path], LOGIT_TOL)
    li, key = XSLOT[name]
    T = lm.context_len(cfg, 20)
    assert got[f"{li}.{key}.k"].shape == (cfg.n_periods, 2, T, cfg.n_kv_heads,
                                          cfg.head_dim)


@pytest.mark.parametrize("name", XATTN)
def test_decode_logits_match_jax(name):
    """Then 4 decode steps from those caches."""
    (jcfg, cfg, jp, tp), (jc, jl), (tcache, tl), rng = _prefill_pair(name)
    for step in range(4):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(20 + step),
                                 jcfg, RULES)
        tl, tcache = lm.decode_step(tp, torch.from_numpy(nxt).long(), tcache,
                                    20 + step, cfg)
        _close(tl, jl, LOGIT_TOL)


def _greedy(prefill, decode, S, steps):
    cache, lg = prefill()
    out = []
    for i in range(steps):
        tok = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
        out.append(tok[:, 0].tolist())
        lg, cache = decode(tok, cache, S + i)
    return out


@pytest.mark.parametrize("name", XATTN)
def test_greedy_streams_match_jax(name):
    """``prefill(ctx_embeds)`` then 10 greedy decode steps, as the
    reference's own tests serve these families: the same tokens."""
    jcfg, cfg, jp, tp = _setup(name)
    rng = np.random.default_rng(7)
    S = 13
    toks = rng.integers(1, cfg.vocab_size, (3, S)).astype(np.int32)
    ctx = _context(cfg, 3, S, seed=2)
    want = _greedy(
        lambda: jlm.prefill(jp, jnp.asarray(toks), jcfg, RULES, 32,
                            ctx_embeds=jnp.asarray(ctx)),
        lambda t, c, p: jlm.decode_step(jp, jnp.asarray(t), c, jnp.int32(p), jcfg,
                                        RULES), S, 10)

    def prefill():
        cache, lg = lm.prefill(tp, torch.from_numpy(toks).long(), cfg, 32,
                               torch.from_numpy(ctx))
        return cache, lg.numpy()

    def decode(t, cache, pos):
        lg, cache = lm.decode_step(tp, torch.from_numpy(t).long(), cache, pos, cfg)
        return lg.numpy(), cache
    assert _greedy(prefill, decode, S, 10) == want


@pytest.mark.parametrize("name", XATTN)
def test_decode_matches_forward(name):
    """``tests/test_arch_smoke.py::test_decode_matches_forward`` on the port:
    prefill(t[:8]) and 8 decode steps give the full prefill's last logits,
    one context throughout (a vlm sample's image; for encdec the frames of
    the full prompt's length)."""
    _, cfg, _, tp = _setup(name)
    B, S, k = 2, 16, 8
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S))).long()
    ctx = torch.from_numpy(_context(cfg, B, S, seed=3))
    _, full_last = lm.prefill(tp, tokens, cfg, S, ctx)
    cache, lg = lm.prefill(tp, tokens[:, :k], cfg, S, ctx)
    for i in range(k, S):
        lg, cache = lm.decode_step(tp, tokens[:, i:i + 1], cache, i, cfg)
    np.testing.assert_allclose(lg[:, 0].numpy(), full_last[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", XATTN)
def test_a_context_family_needs_its_context(name):
    _, cfg, _, tp = _setup(name)
    toks = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="needs ctx_embeds"):
        lm.prefill(tp, toks, cfg, 8)
    with pytest.raises(ValueError, match="needs ctx_embeds"):
        lm.forward_train(tp, toks, cfg)


@pytest.mark.parametrize("name", XATTN)
def test_model_and_cache_defs_match_the_reference(name):
    """At the published config: every leaf of ``model_defs`` (the encoder's
    and ``ctx_proj`` included) and of ``cache_defs`` with its key, shape,
    dtype, init and logical axes; the cross-attention sublayer's defs are
    the attention sublayer's."""
    jcfg, cfg = jax_config(name), get_config(name)
    for got_t, want_t in ((lm.model_defs(cfg), jlm.model_defs(jcfg)),
                          (lm.cache_defs(cfg, 4, 544), jlm.cache_defs(jcfg, 4, 544))):
        got, want = dict(_paths(got_t)), dict(_paths(want_t))
        assert set(got) == set(want)
        for path, pv in got.items():
            w = want[path]
            assert pv.shape == w.shape, path
            assert str(pv.dtype)[6:] == np.dtype(w.dtype).name, path
            assert (pv.init, pv.logical, pv.scale) == (w.init, w.logical, w.scale), path
    assert L.xattn_defs(cfg).keys() == L.attn_defs(cfg).keys()
    if cfg.family == "encdec":
        assert lm.model_defs(cfg)["encoder"]["layers"]["attn"]["wq"].shape == \
            (24, 1024, 1024)
    else:
        assert lm.model_defs(cfg)["ctx_proj"].shape == (7680, 4096)


def test_encdec_cache_defs_hold_no_context_as_the_references():
    """The reference sizes a cross-attention cache by ``n_ctx_tokens``, 0 for
    encdec, whose context length comes from the prompt: a seamless cache
    from ``cache_defs`` holds no context, and only ``prefill``'s cache is
    usable.  The port keeps that shape (its results stay the reference's)."""
    for get, mod in ((get_config, lm), (jax_config, jlm)):
        cfg = get("seamless-m4t-large-v2")
        c = mod.cache_defs(cfg, 4, 1024)["l0"]["s1_xattn"]
        assert c["k"].shape == c["v"].shape == (24, 4, 0, 16, 64)
    vlm = lm.cache_defs(get_config("llama-3.2-vision-11b"), 4, 544)["l2"]["s0_xattn"]
    assert vlm["k"].shape == (8, 4, 6404, 8, 128)


@pytest.mark.parametrize("name", XATTN)
def test_param_counts_and_context_len_match_the_reference(name):
    jcfg, cfg = jax_config(name), get_config(name)
    assert cfg.n_params() == jcfg.n_params()
    for S in (1, 20, 512, 1024, 4096):
        assert lm.context_len(cfg, S) == jlm.context_len(jcfg, S)
    assert lm.context_len(cfg, 1024) == (256 if cfg.family == "encdec" else 6404)


@pytest.mark.parametrize("name", XATTN)
def test_serve_launches_is_the_count_of_prefill_and_decode(monkeypatch, name):
    """Two prefills with their contexts and five decode steps."""
    _, cfg, _, tp = _setup(name)
    counts = _serve_counting(monkeypatch)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for S in (9, 14):
            toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, S))).long()
            cache, lg = lm.prefill(tp, toks, cfg, 32,
                                   torch.from_numpy(_context(cfg, 2, S)))
        for i in range(5):
            lg, cache = lm.decode_step(tp, lg.argmax(-1), cache, 14 + i, cfg)
    assert counts == trainer.serve_launches(cfg, prefills=2, decode_steps=5)


def test_serve_launches_at_the_published_sizes():
    """llama-3.2-vision-11b: 32 self-attention, 8 cross-attention and 40 MLP
    sublayers; seamless: 24 of each kind and 24 encoder layers."""
    vlm = trainer.serve_launches(get_config("llama-3.2-vision-11b"), 1, 32)
    assert {k: v for k, v in vlm.items() if v} == {
        "rmsnorm": 81 * 33, "matmul": (4 * 32 + 3 * 40) * 33 + 4 * 8 + 2 * 8 * 32,
        "flash_attention": 40}
    s2s = trainer.serve_launches(get_config("seamless-m4t-large-v2"), 2, 10)
    assert {k: v for k, v in s2s.items() if v} == {
        "rmsnorm": 73 * 12 + 49 * 2, "matmul": (7 * 24 + 2 * 24) * 12
        + (2 * 24 + 7 * 24) * 2, "flash_attention": 72 * 2}


def test_card_checks_take_the_families_shapes():
    """The shapes at which the card's checks hold the kernels for these
    families are the models': the context K/V projection's rows, K and N,
    seamless's projections and MLP, the heads and context lengths of the
    flash cases, and rmsnorm at seamless's d_model."""
    from repro_torch.testing import kernel_checks as kc
    vlm, s2s = get_config("llama-3.2-vision-11b"), get_config("seamless-m4t-large-v2")
    xa = lm.model_defs(vlm)["period"]["l2"]["s0_xattn"]
    assert kc.XATTN_MATMUL[0][1:] == (4 * lm.context_len(vlm, 512),
                                      *xa["wk"].shape[-2:])
    sub = lm.model_defs(s2s)["period"]["l0"]
    kn = {"seamless wq/wo": tuple(sub["s1_xattn"]["wq"].shape[-2:]),
          "seamless wi": tuple(sub["s2_mlp"]["wi"].shape[-2:]),
          "seamless mlp.wo": tuple(sub["s2_mlp"]["wo"].shape[-2:])}
    for name, M, K, N in kc.XATTN_MATMUL[1:]:
        assert kn[name] == (K, N) and M in (4, 4 * lm.context_len(s2s, 1024), 4096)
    cases = {c[0]: c[1:] for c in kc.XATTN_FLASH_CASES}
    assert cases["vlm train"] == (4, 1024, lm.context_len(vlm, 1024), vlm.n_heads,
                                  vlm.n_kv_heads, vlm.head_dim)
    assert cases["seamless train"] == (4, 1024, lm.context_len(s2s, 1024), s2s.n_heads,
                                       s2s.n_kv_heads, s2s.head_dim)
    assert cases["seamless encoder"][1] == cases["seamless encoder"][2] == 256
    assert {D for _, D in kc.XATTN_NORM} == {s2s.d_model}


def test_xattn_tol_holds_the_bf16_sublayer_against_f64():
    """``kernel_checks.xattn_tol``, the card check's limit, holds the bf16
    plain path of a smoke cross-attention sublayer against its f64 form
    (prefill and decode): the bf16 roundings of q, the context's K/V and
    the attention's output stay inside it."""
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.params import tree_map
    _, cfg, jp, tp = _setup("llama-3.2-vision-11b")
    _, sp = _slot("llama-3.2-vision-11b", jp, tp)
    rng = np.random.default_rng(11)
    x, ctx = (torch.from_numpy(rng.normal(size=(2, n, cfg.d_model)).astype(np.float32))
              for n in (9, 37))
    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    bsp = {k: (t.to(torch.bfloat16) if t.ndim == 2 else t) for k, t in sp.items()}
    dcfg = dataclasses.replace(cfg, dtype=torch.float64)
    dsp = tree_map(lambda t: t.double(), bsp)
    xb, cb = x.to(torch.bfloat16), ctx.to(torch.bfloat16)
    got, kv = L.xattn_layer_prefill(bsp, xb, cb, bcfg)
    want = L.xattn_layer(dsp, xb.double(), cb.double(), dcfg)
    rtol, atol = kc.xattn_tol(bsp, xb, cb, bcfg)
    assert kc.compare(got.reshape(-1, cfg.d_model).double(),
                      want.reshape(-1, cfg.d_model), (rtol, atol.double()))["limit_use"] <= 1
    xt = xb[:, :1]
    got, _ = L.xattn_layer_decode(bsp, xt, kv, bcfg)
    want, _ = L.xattn_layer_decode(dsp, xt.double(), L.XAttnCache(*(t.double() for t in kv)),
                                   dcfg)
    rtol, atol = kc.xattn_tol(bsp, xt, cb, bcfg, kv)
    assert kc.compare(got.reshape(-1, cfg.d_model).double(),
                      want.reshape(-1, cfg.d_model), (rtol, atol.double()))["limit_use"] <= 1
