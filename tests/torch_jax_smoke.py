"""The JAX side of the port's smoke training checks for the MoE, Mamba and
cross-attention archs: the JAX initialiser's smoke weights (seed 0) as numpy files beside
llama3-8b's, and JAX's train steps from them.

    PYTHONPATH=src python tests/torch_jax_smoke.py

writes the weight files.  ``chip_smoke.py`` (phase 4b) trains the port
from them on the card and on the CPU without importing JAX
(``testing/train_checks.py``); ``tests/test_torch_moe.py``,
``tests/test_torch_ssm_train.py`` and ``tests/test_torch_xattn_train.py``
check that each file still equals
``repro.parallel.sharding.init_params`` of the arch's smoke model at
``jax.random.key(0)`` and hold the port's train steps against
:func:`jax_smoke_run`, its gradients against ``jax.grad``
(:func:`assert_grads_match_jax`) and its launch counts against a counted
step (:func:`count_train_step`).  Keys are the tree's dotted paths.  llama3-8b's file
comes from ``scripts/make_torch_smoke_weights.py``, the same way.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.models import lm
from repro.parallel.sharding import default_rules, init_params
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.kernels import flash_attention, matmul, rmsnorm
from repro_torch.launch.train import step_context
from repro_torch.models.lm import CONTEXT_FAMILIES
from repro_torch.params import params_from_jax
from repro_torch.testing import train_checks as tc
from repro_torch.train import trainer

#: the archs whose weights this file writes (qwen3-moe reads mixtral's:
#: ``train_checks.SAME_WEIGHTS``)
ARCHS = tuple(a for a in tc.SMOKE_ARCHS
              if a != tc.ARCH and a not in tc.SAME_WEIGHTS)
RULES = default_rules(None)
#: the loss's rtol and each gradient leaf's (rtol, share of the leaf's
#: largest element), as ``tests/test_torch_train.py`` states them
LOSS_RTOL = 1e-5
GRAD_TOL = (1e-4, 2e-5)


def jax_smoke_weights(arch: str) -> dict:
    """{dotted path: f32 array} of the arch's smoke model's JAX init at key 0."""
    params = init_params(lm.model_defs(get_smoke_config(arch)), jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {".".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in flat}


def _reorder(like, tree):
    """``tree`` in ``like``'s key order (the port's trees keep the file's
    order; JAX sorts keys)."""
    if isinstance(like, dict):
        return {k: _reorder(like[k], tree[k]) for k in like}
    return tree


def _reorder_state(like, tree):
    if isinstance(like, dict):
        return {k: _reorder_state(like[k], tree[k]) for k in like}
    return {k: tree[k] for k in ("m", "v", "master") if k in tree}


def jax_smoke_run(arch: str, steps: int, n_microbatches: int, **over) -> dict:
    """``train_checks.run_smoke(arch=arch)``'s readings from the JAX package:
    the loss and gradients at the init, then ``steps`` jitted train steps on
    the same batches, as torch tensors.  ``over`` replaces fields of the
    smoke config (a capacity factor, say)."""
    jcfg = dataclasses.replace(get_smoke_config(arch), **over)
    jp = init_params(lm.model_defs(jcfg), jax.random.key(0))
    batches = [{"tokens": jnp.asarray(b)} for b in tc.smoke_batches(steps, arch=arch)]
    for b, c in zip(batches, tc.smoke_contexts(steps, arch=arch)):
        if c is not None:
            b["ctx"] = jnp.asarray(c)
    jl, jg = jax.value_and_grad(
        lambda p: lm.forward_train(p, batches[0]["tokens"], jcfg, RULES,
                                   batches[0].get("ctx")))(jp)
    o = tc.opt_config(steps)
    jo = jopt.OptConfig(lr=o.lr, warmup_steps=o.warmup_steps,
                        total_steps=o.total_steps)
    state = jtrainer.TrainState(jp, jopt.adamw_init(jp, jo))
    step = jax.jit(jtrainer.make_train_step(jcfg, RULES, jo,
                                            n_microbatches=n_microbatches))
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    to_t = lambda t: params_from_jax(jax.tree.map(np.asarray, t))
    tp = tc.smoke_params(arch)
    return {"loss0": float(jl), "grads0": _reorder(tp, to_t(jg)), "metrics": metrics,
            "params": _reorder(tp, to_t(state.params)),
            "opt": {"step": torch.tensor(int(state.opt["step"])),
                    "params": _reorder_state(tp, to_t(state.opt["params"]))}}


def _paths(tree, pre=""):
    """(dotted path, leaf) of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}.{k}" if pre else k)
    else:
        yield pre, tree


def assert_weights_file_is_the_jax_init(arch: str) -> None:
    want = jax_smoke_weights(arch)
    got = dict(_paths(tc.smoke_params(arch)))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)


def assert_grads_match_jax(jcfg, cfg, jp, tp, toks, grad_tol=GRAD_TOL,
                           ctx=None) -> None:
    """The loss and every gradient leaf of the port's ``forward_train``
    against ``jax.value_and_grad`` of the JAX model's, on tokens ``toks``
    (and the numpy context ``ctx``)."""
    jl, jg = jax.value_and_grad(
        lambda p: lm.forward_train(p, jnp.asarray(toks), jcfg, RULES,
                                   None if ctx is None else jnp.asarray(ctx)))(jp)
    tl, tg = trainer.loss_and_grads(trainer.trainable(tp),
                                    torch.from_numpy(toks).long(), cfg,
                                    None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    want = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = dict(_paths(tg))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), w, rtol=grad_tol[0],
                                   atol=grad_tol[1] * np.abs(w).max(),
                                   err_msg=path)


def count_train_step(monkeypatch, cfg, n_microbatches: int) -> dict:
    """The launches one train step of ``cfg`` would make on the card: the
    calls of the three Functions whose calls launch the kernels there,
    forward and backward (one ``matmul_bwd`` a product made)."""
    counts = {}
    for cls, fwd, bwd in ((rmsnorm.RMSNorm, "rmsnorm", "rmsnorm_bwd"),
                          (matmul.Matmul, "matmul", "matmul_bwd"),
                          (flash_attention.FlashAttention, "flash_attention",
                           "flash_attention_bwd")):
        for attr, key in (("forward", fwd), ("backward", bwd)):
            counts[key] = 0
            orig = getattr(cls, attr)

            def wrapped(ctx, *a, _orig=orig, _key=key):
                out = _orig(ctx, *a)
                counts[_key] += (sum(o is not None for o in out)
                                 if _key == "matmul_bwd" else 1)
                return out
            monkeypatch.setattr(cls, attr, staticmethod(wrapped))
    state = trainer.init_train_state(cfg, tc.opt_config(1),
                                     torch.Generator().manual_seed(0), "cpu")
    step = trainer.make_train_step(cfg, tc.opt_config(1),
                                   n_microbatches=n_microbatches)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    batch = {"tokens": torch.from_numpy(toks).long()}
    if cfg.family in CONTEXT_FAMILIES:
        batch["ctx"] = torch.from_numpy(step_context(cfg, 0, 2, 12))
    step(state, batch)
    return counts


if __name__ == "__main__":
    for arch in ARCHS:
        out = tc.weights_path(arch)
        np.savez_compressed(out, **jax_smoke_weights(arch))
        print(f"wrote {out} ({out.stat().st_size} bytes)")
