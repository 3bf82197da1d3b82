"""The Mamba2 family (mamba2-370m, and the jamba hybrid's Mamba sublayers)
through the port against the JAX package (CPU, f32 smoke configs, the JAX
initialiser's weights carried over by ``params_from_jax``, inputs from a
numpy seed): the chunked SSD, the Mamba sublayer with and without carried
states, the one-token step, prefill then decode against the forward, the
dense engine's greedy streams, the paged engine's refusal, the
parameter trees and counts, and the port's one deliberate difference from
the reference: the SSD's decay masked before its exponential.  Training,
the launch counts and the launchers are ``test_torch_ssm_train.py``.

Tolerances (f32 on both sides; the einsums, the cumulative sums and the
sums run in other orders, so no output is the same bits across the two
frameworks):
  * the SSD's output and state: ``|d| <= 1e-5 |want| + 2e-5 max|want|``
    (measured <= 4.9e-6 of the largest element: an output is a sum of
    terms ~10x its size, and a 223-row chunk's decay comes from a
    cumulative sum to ~-150 whose rounding differs);
  * a sublayer, its states and a decode step: ``|d| <= 1e-5 + 1e-5
    |want|``;
  * logits through whole models: ``|d| <= 1e-4 + 1e-4 |want|`` (jamba's
    16 layers, 8 of them MoE, measured ~2.3e-5 against logits up to 3.5);
  * the SSD's gradients at chunk 256 against the reference's at chunk 16:
    ``|d| <= 1e-4 |want| + 1e-5 max|want|`` (the chunked form is exact
    whatever the chunk; only rounding differs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules, init_params as jax_init
from repro.serve import PagedServeConfig as JPagedServeConfig
from repro.serve import PagedServingEngine as JPagedServingEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.params import params_from_jax
from repro_torch.serve import (PagedServeConfig, PagedServingEngine, Request,
                               ServeConfig, ServingEngine)
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

RULES = default_rules(None)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SSM = ["mamba2-370m", "jamba-1.5-large-398b"]
#: the masked-exponential case: B = 1, S = 512, 4 heads of 8, state 16
MASK_CASE = dict(B=1, S=512, H=4, P=8, N=16)


def _setup(name, **over):
    jcfg = dataclasses.replace(jax_smoke_config(name), **over)
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _close_scaled(got: torch.Tensor, want, rtol=1e-5, share=2e-5):
    """``|d| <= rtol |want| + share max|want|``."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=share * np.abs(want).max())


def _mamba_slot(name):
    """The first Mamba sublayer's (JAX, port) params of the arch."""
    jcfg, cfg, jp, tp = _setup(name)
    key = "s0_mamba"
    jsp = jax.tree.map(lambda t: t[0], jp["period"]["l0"][key])
    sp = jax.tree.map(lambda t: t[0], tp["period"]["l0"][key])
    return jcfg, cfg, jsp, sp


def _ssd_inputs(B, S, H, P, N, seed=0, dt_scale=0.5):
    """f32 xh, dt (softplus of a normal), B, C and a negative A."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(dt_scale * rng.normal(size=(B, S, H)))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    A = -np.exp(0.5 * rng.normal(size=(H,))).astype(np.float32)
    return xh, dt, Bm, Cm, A


def test_chunk_rule_is_the_references():
    """min(chunk, S) lowered until it divides S: a 223-token prompt is one
    223-row chunk at chunk 256, 445 tokens five chunks of 89."""
    assert L.ssd_chunk_len(256, 223) == 223
    assert L.ssd_chunk_len(256, 445) == 89
    assert L.ssd_chunk_len(256, 4608) == 256
    assert L.ssd_chunk_len(8, 35) == 7
    assert L.ssd_chunk_len(16, 223) == 1


@pytest.mark.parametrize("chunk", [16, 256])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "state_in"])
@pytest.mark.parametrize("S", [8, 35, 64, 223])
def test_ssd_chunked_matches_jax(S, with_state, chunk):
    """y and the final state, from a zero state and from a given one; at
    chunk 16 the lengths take 1, 5, 4 and 223 chunks, at 256 one each."""
    xh, dt, Bm, Cm, A = _ssd_inputs(2, S, 4, 8, 16, seed=S)
    s0 = (np.random.default_rng(1).normal(size=(2, 4, 8, 16)).astype(np.float32)
          if with_state else None)
    jy, js = JL._ssd_chunked(*map(jnp.asarray, (xh, dt, Bm, Cm, A)), chunk,
                             None if s0 is None else jnp.asarray(s0))
    ty, ts = L._ssd_chunked(*map(torch.from_numpy, (xh, dt, Bm, Cm, A)), chunk,
                            None if s0 is None else torch.from_numpy(s0))
    _close_scaled(ty, jy)
    _close_scaled(ts, js)


def _reference_decay(dA_cs: torch.Tensor) -> torch.Tensor:
    """The reference's form, ``where(causal, exp(seg), 0)``, in torch."""
    Q = dA_cs.shape[2]
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    return torch.where(causal, torch.exp(seg), 0.0)


def test_masked_exponential_keeps_the_forward_bits(monkeypatch):
    """At chunk 256 with dt = softplus(N(0, 1)) and A = -1: the unmasked
    exponential overflows above the diagonal (seg reaches hundreds), and the
    masked form gives the reference form's decay and SSD output bit for bit
    in the same arithmetic (exp(-inf) is exactly the 0 that ``where``
    picks).  Across the two frameworks the output agrees within rounding
    (``test_ssd_gradient_is_finite_at_the_published_chunk``)."""
    xh, dt, Bm, Cm, _ = _ssd_inputs(**MASK_CASE, dt_scale=1.0)
    A = -np.ones(MASK_CASE["H"], np.float32)
    dA_cs = torch.cumsum(torch.from_numpy(dt * A).reshape(1, 2, 256, 4), dim=2)
    seg = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]
    assert bool(torch.isinf(torch.exp(seg)).any()) and float(seg.max()) > 150
    assert torch.equal(L.segment_decay(dA_cs), _reference_decay(dA_cs))
    ins = [torch.from_numpy(a) for a in (xh, dt, Bm, Cm, A)]
    y, s = L._ssd_chunked(*ins, 256)
    monkeypatch.setattr(L, "segment_decay", _reference_decay)
    y_ref, s_ref = L._ssd_chunked(*ins, 256)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    assert bool(torch.isfinite(y).all())


def _ssd_loss(fn, xh, dt, Bm, Cm, A, chunk, wy, ws):
    y, s = fn(xh, dt, Bm, Cm, A, chunk)
    return (y * wy).sum() + (s * ws).sum()


def test_ssd_gradient_is_finite_at_the_published_chunk():
    """dt = softplus(N(0, 1)) and A = -1 (the init ``A_log = 0``) at chunk
    256: the reference's gradient with respect to dt and A is not finite
    (``repro/models/layers.py:817``), the port's is, and it equals the
    reference's at chunk 16, where nothing overflows; the port's forward at
    256 equals its forward at 16 and the reference's within the SSD's
    tolerance."""
    xh, dt, Bm, Cm, _ = _ssd_inputs(**MASK_CASE, dt_scale=1.0)
    A = -np.ones(MASK_CASE["H"], np.float32)
    rng = np.random.default_rng(7)
    wy = rng.normal(size=xh.shape).astype(np.float32)
    ws = rng.normal(size=(1, 4, 8, 16)).astype(np.float32)
    ins = (xh, dt, Bm, Cm, A)

    def jgrad(chunk):
        return jax.grad(lambda *a: _ssd_loss(JL._ssd_chunked, *a, chunk,
                                             jnp.asarray(wy), jnp.asarray(ws)),
                        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))

    j256, j16 = jgrad(256), jgrad(16)
    assert not np.isfinite(np.asarray(j256[1])).all()       # d/d dt
    assert not np.isfinite(np.asarray(j256[4])).all()       # d/d A
    assert all(np.isfinite(np.asarray(g)).all() for g in j16)

    tin = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    loss = _ssd_loss(L._ssd_chunked, *tin, 256, torch.from_numpy(wy),
                     torch.from_numpy(ws))
    grads = torch.autograd.grad(loss, tin)
    for g, w in zip(grads, j16):
        w = np.asarray(w)
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())
    y256, _ = L._ssd_chunked(*map(torch.from_numpy, ins), 256)
    y16, _ = L._ssd_chunked(*map(torch.from_numpy, ins), 16)
    jy, _ = JL._ssd_chunked(*map(jnp.asarray, ins), 256)
    _close_scaled(y256, jy)
    _close_scaled(y256, y16.numpy())


@pytest.mark.parametrize("name", SSM)
@pytest.mark.parametrize("S", [16, 35])
def test_mamba_layer_matches_jax(name, S):
    """Output and states (``return_state``) from zero states, then the next
    S tokens from those states."""
    jcfg, cfg, jsp, sp = _mamba_slot(name)
    rng = np.random.default_rng(S)
    x1, x2 = (rng.normal(size=(2, S, cfg.d_model)).astype(np.float32) for _ in range(2))
    jo, (jc, js) = JL.mamba_layer(jsp, jnp.asarray(x1), jcfg, RULES, return_state=True)
    to, (tc, ts) = L.mamba_layer(sp, torch.from_numpy(x1), cfg, return_state=True)
    for got, want in ((to, jo), (tc, jc), (ts, js)):
        _close(got, want)
    jo2, (jc2, js2) = JL.mamba_layer(jsp, jnp.asarray(x2), jcfg, RULES,
                                     conv_state=jc, ssm_state=js, return_state=True)
    to2, (tc2, ts2) = L.mamba_layer(sp, torch.from_numpy(x2), cfg, conv_state=tc,
                                    ssm_state=ts, return_state=True)
    for got, want in ((to2, jo2), (tc2, jc2), (ts2, js2)):
        _close(got, want)
    assert tuple(tc.shape) == (2, cfg.ssm_conv - 1, cfg.d_inner_ssm + 2 * cfg.ssm_state)
    assert tuple(ts.shape) == (2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)


@pytest.mark.parametrize("name", SSM)
def test_mamba_layer_decode_matches_jax(name):
    """Four one-token steps from a prefilled state: output, conv window and
    state each step; the port writes them into its cache in place."""
    jcfg, cfg, jsp, sp = _mamba_slot(name)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 12, cfg.d_model)).astype(np.float32)
    _, (jc, js) = JL.mamba_layer(jsp, jnp.asarray(x), jcfg, RULES, return_state=True)
    _, (tc, ts) = L.mamba_layer(sp, torch.from_numpy(x), cfg, return_state=True)
    jcache = JL.MambaCache(jc, js)
    cache = L.MambaCache(tc.clone(), ts.clone())
    for _ in range(4):
        xt = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
        jo, jcache = JL.mamba_layer_decode(jsp, jnp.asarray(xt), jcache, jcfg, RULES)
        to, out_cache = L.mamba_layer_decode(sp, torch.from_numpy(xt), cache, cfg)
        assert out_cache.conv is cache.conv and out_cache.state is cache.state
        _close(to, jo)
        _close(cache.conv, jcache.conv)
        _close(cache.state, jcache.state)


def test_mamba_defs_match_the_reference():
    """Keys, shapes and dtypes of the Mamba sublayer's params and cache at
    mamba2-370m's published width: A_log, D, dt_bias, norm and gnorm f32,
    in_proj, conv_w, conv_b and out_proj in the model dtype."""
    from repro.configs import get_config as jax_config
    jcfg, cfg = jax_config("mamba2-370m"), get_config("mamba2-370m")
    want = JL.mamba_defs(jcfg)
    got = L.mamba_defs(cfg)
    assert list(got) == list(want)
    for k, pv in got.items():
        assert pv.shape == want[k].shape, k
        assert str(pv.dtype)[6:] == np.dtype(want[k].dtype).name, k
        assert pv.init == want[k].init and pv.logical == want[k].logical, k
    assert got["in_proj"].shape == (1024, 4384)
    jc, tc = JL.mamba_cache_defs(jcfg, 4), L.mamba_cache_defs(cfg, 4)
    for a, b in zip(tc, jc):
        assert a.shape == b.shape and str(a.dtype)[6:] == np.dtype(b.dtype).name


@pytest.mark.parametrize("name", [*SSM, "mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "llama3-8b", "phi3-mini-3.8b"])
def test_param_counts_match_the_reference(name):
    """``n_params``, ``n_active_params`` and the derived SSM widths of the
    published configs equal the reference's."""
    from repro.configs import get_config as jax_config
    jcfg, cfg = jax_config(name), get_config(name)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert (cfg.ssm_conv, cfg.d_inner_ssm, cfg.n_ssm_heads) == \
        (jcfg.ssm_conv, jcfg.d_inner_ssm, jcfg.n_ssm_heads)
    for f in dataclasses.fields(jcfg):
        if hasattr(cfg, f.name) and f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("name", SSM)
def test_prefill_and_decode_logits_match_jax(name):
    """A 20-token prompt, then 4 decode steps."""
    jcfg, cfg, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 20)).astype(np.int32)
    jc, jl = jlm.prefill(jp, jnp.asarray(toks), jcfg, RULES, 32)
    tc, tl = lm.prefill(tp, torch.from_numpy(toks).long(), cfg, 32)
    _close(tl, jl, LOGIT_TOL)
    for step in range(4):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(20 + step),
                                 jcfg, RULES)
        tl, tc = lm.decode_step(tp, torch.from_numpy(nxt).long(), tc, 20 + step, cfg)
        _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("name", SSM)
def test_decode_matches_forward(name):
    """``tests/test_arch_smoke.py::test_decode_matches_forward`` on the port:
    prefill(t[:8]) and 8 decode steps give the full prefill's last logits."""
    _, cfg, _, tp = _setup(name)
    B, S, k = 2, 16, 8
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S))).long()
    _, full_last = lm.prefill(tp, tokens, cfg, S)
    cache, lg = lm.prefill(tp, tokens[:, :k], cfg, S)
    for i in range(k, S):
        lg, cache = lm.decode_step(tp, tokens[:, i:i + 1], cache, i, cfg)
    np.testing.assert_allclose(lg[:, 0].numpy(), full_last[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)


def _drive(engine, prompts, req=Request, new=12):
    reqs = [req(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.rid: list(r.out) for r in reqs}


@pytest.mark.parametrize("name", SSM)
def test_paged_engine_refuses_mamba_as_jax_does(name):
    jcfg, cfg, jp, tp = _setup(name)
    scfg = dict(max_batch=4, max_seq=64, block_tokens=8, n_blocks=32)
    with pytest.raises(ValueError, match="attention caches only") as jerr:
        JPagedServingEngine(jcfg, jp, RULES, JPagedServeConfig(**scfg))
    with pytest.raises(ValueError, match="attention caches only") as err:
        PagedServingEngine(lm.Model(cfg, tp), PagedServeConfig(**scfg), device="cpu")
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("name", SSM)
def test_params_from_jax_maps_the_trees(name):
    """The carried-over tree has the JAX tree's paths, shapes and values, for
    the f32 smoke tree and for the bf16 leaves of the model dtype."""
    jcfg, cfg, jp, tp = _setup(name)
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16))
                      if t.ndim >= 3 else np.asarray(t), jp)
    tb = params_from_jax(bf)
    flat = jax.tree_util.tree_flatten_with_path(bf)[0]
    assert len(flat) == len(jax.tree.leaves(tp))
    for path, want in flat:
        got, node = tb, tp
        for k in path:
            got, node = got[k.key], node[k.key]
        assert tuple(got.shape) == want.shape
        assert got.dtype == (torch.bfloat16 if want.ndim >= 3 else torch.float32)
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
        assert node.dtype == torch.float32



def test_card_checks_take_mamba2s_shapes():
    """The (K, N) at which the card's checks hold the matmul for mamba2-370m
    are its two projections', and rmsnorm's widths its two norms'."""
    from repro_torch.testing import kernel_checks as kc
    cfg = get_config("mamba2-370m")
    sub = lm.model_defs(cfg)["period"]["l0"]["s0_mamba"]
    assert {k: tuple(sub[k].shape[-2:]) for k in kc.MAMBA_MATMUL_KN} == kc.MAMBA_MATMUL_KN
    assert (sub["norm"].shape[-1], sub["gnorm"].shape[-1]) == kc.MAMBA_NORM_D
    assert kc.MAMBA_ROWS[-1] == 4 * 1024 and cfg.norm_eps == kc.EPS
