"""The port's attention and MLP sublayers against the JAX layers, with the
JAX initialiser's weights carried over by ``params_from_jax`` and the same
numpy inputs on both sides (f32 smoke configs, on the CPU)."""
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
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.params import params_from_jax

RULES = default_rules(None)
# f32 on both sides; only the summation order of the products differs
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {"llama3": {}, "swa8": {"window": 8}, "glm4": None}


def _cfgs(case):
    over = CASES[case]
    name = "glm4-9b" if over is None else "llama3-8b"
    over = over or {}
    return (dataclasses.replace(jax_smoke_config(name), **over),
            dataclasses.replace(get_smoke_config(name), **over))


def _sublayer(jcfg, kind):
    """Period 0 of one sublayer's JAX weights, and the port's copy."""
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    key = "s0_attn" if kind == "attn" else "s1_mlp"
    jsp = jax.tree.map(lambda t: t[0], jp["period"]["l0"][key])
    return jsp, params_from_jax(jax.tree.map(np.asarray, jsp))


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [6, 12])
@pytest.mark.parametrize("case", list(CASES))
def test_attn_layer_prefill(case, S):
    jcfg, cfg = _cfgs(case)
    jsp, sp = _sublayer(jcfg, "attn")
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    W = JL.attn_cache_len(jcfg, 16)
    jy, jc = JL.attn_layer_prefill(jsp, jnp.asarray(x), jcfg, RULES,
                                   jnp.arange(S), W)
    y, c = L.attn_layer_prefill(sp, torch.from_numpy(x), cfg,
                                torch.arange(S), W)
    _close(y, jy)
    _close(c.k, jc.k)
    _close(c.v, jc.v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ["llama3", "swa8"])
def test_attn_layer(case, causal):
    jcfg, cfg = _cfgs(case)
    jsp, sp = _sublayer(jcfg, "attn")
    x = np.random.default_rng(4).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    jy = JL.attn_layer(jsp, jnp.asarray(x), jcfg, RULES, jnp.arange(12),
                       causal=causal)
    y = L.attn_layer(sp, torch.from_numpy(x), cfg, torch.arange(12),
                     causal=causal)
    _close(y, jy)


@pytest.mark.parametrize("pos", [5, 13, (3, 9), (13, 2)])
@pytest.mark.parametrize("case", list(CASES))
def test_attn_layer_decode(case, pos):
    """Scalar and per-slot positions; with window 8 and a 16-row cache the
    ring wraps for positions past 8."""
    jcfg, cfg = _cfgs(case)
    jsp, sp = _sublayer(jcfg, "attn")
    rng = np.random.default_rng(7)
    W = JL.attn_cache_len(jcfg, 16)
    shp = (2, W, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = (rng.normal(size=shp).astype(np.float32) for _ in range(2))
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jpos = jnp.asarray(pos, jnp.int32)
    jy, jc = JL.attn_layer_decode(jsp, jnp.asarray(x),
                                  JL.AttnCache(jnp.asarray(ck), jnp.asarray(cv)),
                                  jpos, jcfg, RULES)
    cache = L.AttnCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    y, c = L.attn_layer_decode(sp, torch.from_numpy(x), cache,
                               torch.tensor(pos), cfg)
    _close(y, jy)
    _close(c.k, jc.k)
    _close(c.v, jc.v)


@pytest.mark.parametrize("case", ["llama3", "glm4"])
def test_mlp_layer(case):
    jcfg, cfg = _cfgs(case)
    jsp, sp = _sublayer(jcfg, "mlp")
    x = np.random.default_rng(1).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    jy = JL.mlp_layer(jsp, jnp.asarray(x), jcfg, RULES)
    _close(L.mlp_layer(sp, torch.from_numpy(x), cfg), jy)


def test_expand_kv_order_is_jnp_repeat():
    """The plain attention's kv heads (B, Hkv, T, D) repeat as jnp.repeat
    does, so query head h reads kv head h // (H / Hkv)."""
    k = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
    want = np.repeat(k, 3, axis=1)
    np.testing.assert_array_equal(ref.expand_kv(torch.from_numpy(k), 6).numpy(),
                                  want)


def test_rope_matches_jax_for_per_slot_positions():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    pos = np.array([[0], [7], [300]])
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    _close(got, want)
