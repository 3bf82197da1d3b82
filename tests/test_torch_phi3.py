"""Head dim 96 (phi3-mini-3.8b) through the port, on the CPU.

Every registered dense architecture's head dim at its published width is
one both attention kernels take, and D = 96 goes to the wgmma kernels in
bf16 (a row as two 64-column boxes, the second zero-filled past column 96)
and to the simt kernels in f32 or from unaligned views.  Then a phi3
variant at its published head dim, 96 (d_model 192, 2 heads, 2 layers, f32, made with
``dataclasses.replace`` on both sides), against the JAX package: the loss
and every gradient leaf of ``forward_train`` within
``tests/test_torch_train.py``'s tolerances, and the greedy token streams of
the serving engine, equal.  This also covers RoPE at a half-width of 48.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules, init_params as jax_init
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import archs, get_config, get_smoke_config
from repro_torch.kernels import flash_attention, paged_attention
from repro_torch.models import lm
from repro_torch.params import params_from_jax
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.testing import kernel_checks as kc
from repro_torch.train import trainer
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

RULES = default_rules(None)
# as tests/test_torch_train.py states them
LOSS_RTOL = 1e-5
GRAD_TOL = (1e-4, 2e-5)
#: phi3-mini's published head dim on a narrow model
D96 = dict(d_model=192, n_heads=2, n_kv_heads=2, d_head=96, n_layers=2)
DENSE = sorted(n for n, c in archs.CONFIGS.items() if c.family == "dense")
#: every arch the port serves with attention: the dense family, the MoE
#: family, the jamba hybrid and the cross-attention families (mamba2-370m
#: has no attention sublayer)
SERVED = DENSE + sorted(n for n, c in archs.CONFIGS.items()
                        if c.family in ("moe", "hybrid", "encdec", "vlm"))


def test_the_dense_archs_are_the_four_the_port_runs():
    assert DENSE == ["deepseek-7b", "glm4-9b", "llama3-8b", "phi3-mini-3.8b"]


@pytest.mark.parametrize("name", SERVED)
def test_every_dense_arch_head_dim_has_both_attention_kernels(name):
    """At its published width (phi3-mini: 3072 / 32 = 96), and the MoE
    archs', jamba's and llama-3.2-vision's too (128), and seamless's (64);
    in bf16 each takes the wgmma kernels, forward and backward, at its
    self-attention's S = Sk and its cross-attention's Sk != S; the backward
    over vlm's 6,404 image tokens (``STATS_MIN_SK`` keys or more) their
    stats instances, which read the forward's statistics."""
    D = get_config(name).head_dim
    assert D in flash_attention.HEAD_DIMS
    assert D in paged_attention.HEAD_DIMS
    for S, Sk in ((1024, 1024), (35, 6404), (1024, 256)):
        want = "stats" if Sk >= flash_attention.STATS_MIN_SK else "wgmma"
        assert flash_attention.variant(S, Sk, D, torch.bfloat16) == "wgmma"
        assert flash_attention.bwd_variant(S, Sk, D, torch.bfloat16) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1, 70, 512, 1024])
def test_head_dim_96_takes_wgmma_in_bf16_and_simt_in_f32(S, dtype):
    """Aligned calls with keys (f32 there takes the TF32 tensor-core
    kernels, tf32x3; simt keeps f32's unaligned views and Sk = 0); those
    and bf16's unaligned views and Sk = 0 are rows of the
    variant tables of ``tests/test_torch_kernels.py`` and
    ``tests/test_torch_flash_bwd.py``."""
    want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    assert flash_attention.variant(S, S, 96, dtype) == want
    assert flash_attention.bwd_variant(S, S, 96, dtype) == want
    # D = 96 on the two boxes of D = 128, its last 32 columns zero
    assert flash_attention.WGMMA_HEAD_DIMS == (64, 96, 128)
    assert flash_attention.box_plan(96).cols == 128


def _setup():
    jcfg = dataclasses.replace(jax_smoke_config("phi3-mini-3.8b"), **D96)
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"), **D96)
    assert cfg.head_dim == jcfg.head_dim == 96
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _jax_flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, pre + f"['{k}']")
    else:
        yield pre, tree


def test_head_dim_96_loss_and_every_grad_leaf_match_jax():
    jcfg, cfg, jp, tp = _setup()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jg = jax.value_and_grad(
        lambda p: jlm.forward_train(p, jnp.asarray(toks), jcfg, RULES))(jp)
    tl, tg = trainer.loss_and_grads(trainer.trainable(tp),
                                    torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    want = _jax_flat(jg)
    got = dict(_paths(tg))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL[0],
                                   atol=GRAD_TOL[1] * np.abs(w).max(), err_msg=path)


def test_head_dim_96_greedy_streams_match_jax():
    """5 requests through 2 slots, max_seq 64: prefill and decode give the
    JAX engine's tokens."""
    jcfg, cfg, jp, tp = _setup()
    jeng = JServingEngine(jcfg, jp, RULES, JServeConfig(max_batch=2, max_seq=64))
    eng = ServingEngine(lm.Model(cfg, tp), ServeConfig(max_batch=2, max_seq=64),
                        device="cpu")
    rng = np.random.default_rng(1)
    for rid in range(5):
        prompt = rng.integers(1, cfg.vocab_size, int(rng.integers(4, 24))).astype(np.int32)
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new_tokens=12))
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=12))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    assert got == want and len(got) == 5


@pytest.mark.parametrize("name,kn,width", [
    ("llama3-8b", kc.MATMUL_KN, kc.D_MODEL),
    ("phi3-mini-3.8b", kc.PHI3_MATMUL_KN, kc.PHI3_D_MODEL),
    ("mixtral-8x7b", kc.MATMUL_KN, kc.D_MODEL)],
    ids=["llama3-8b", "phi3-mini-3.8b", "mixtral-8x7b"])
def test_card_checks_take_the_models_shapes(name, kn, width):
    """The (K, N) at which the card's checks hold the matmul are those of
    the model's projections, every one and no other (an expert's are its
    weight's last two dims), and rmsnorm's width is its d_model."""
    cfg = get_config(name)
    leaves = [(k, v) for blk in lm.model_defs(cfg)["period"].values()
              for sub in blk.values() for k, v in sub.items()]
    assert {tuple(v.shape[-2:]) for k, v in leaves if k.startswith("w")} == set(kn.values())
    assert {v.shape[-1] for k, v in leaves if k == "norm"} == {width} == {cfg.d_model}
