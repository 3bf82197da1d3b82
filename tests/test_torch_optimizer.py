"""The port's AdamW against the JAX package's on the same numpy inputs
(CPU): ``lr_schedule``, ``opt_state_defs``/``adamw_init`` and
``adamw_update`` over several steps, with the clip on and off, bf16 params
with an f32 master, bf16 moments, and a layer-stacked leaf (updated a slice at a time on both sides).

Tolerances: the same f32 operations in the same order on both sides, but
XLA and torch round pow, sqrt and division by their own routines, and XLA
may fuse a product into the next addition (one rounding, not two): f32
results within rtol 2e-6 (a few ulp) plus 1e-6 of the leaf's largest
element (an m of 3e-4 beside a product of ~1e-2 moves by ~1e-9); bf16
results (params without a master, bf16 moments or arithmetic) within one
bf16 ulp (rtol 8e-3) plus 1e-6 of the leaf's largest element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.params import PV, params_from_jax, tree_leaves
from repro_torch.train import optimizer as opt
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

F32_RTOL, BF16_RTOL, ATOL_SHARE = 2e-6, 8e-3, 1e-6

# leaves of a small model: matrices (decayed), vectors (not), a stacked
# (8, ...) leaf the update walks a slice at a time
SHAPES = {"w": (16, 24), "norm": (24,), "stack": {"wi": (8, 6, 10)}}


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in shapes.items()}


def _jdt(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


def _close(got, want, bf16):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=BF16_RTOL if bf16 else F32_RTOL,
                               atol=ATOL_SHARE * float(np.abs(want).max()))


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=3, total_steps=10),
                                dict(warmup_steps=0, total_steps=1, lr=1e-2)],
                         ids=["default", "short", "no-warmup"])
def test_lr_schedule_matches_jax(kw):
    cfg, jcfg = opt.OptConfig(**kw), jopt.OptConfig(**kw)
    for step in [0, 1, 2, 3, 5, 9, 10, 50, 100, 101, 5000, 10_000, 20_000]:
        got = opt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.lr_schedule(jcfg, jnp.int32(step))
        _close(got, want, bf16=False)


CASES = {
    "f32 clip": (torch.float32, dict()),
    "f32 no clip": (torch.float32, dict(clip_norm=0.0)),
    "bf16 params f32 master": (torch.bfloat16, dict()),
    "bf16 params no master": (torch.bfloat16, dict(master_fp32=False)),
    "bf16 state": (torch.float32, dict(state_dtype="bf16")),
    "bf16 params bf16 state": (torch.bfloat16, dict(state_dtype="bf16")),
}


def _configs(kw):
    tkw, jkw = dict(kw, lr=1e-2, warmup_steps=2), dict(kw, lr=1e-2, warmup_steps=2)
    for key in ("state_dtype", "math_dtype"):
        if kw.get(key) == "bf16":
            tkw[key], jkw[key] = torch.bfloat16, jnp.bfloat16
    return opt.OptConfig(**tkw), jopt.OptConfig(**jkw)


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_update_matches_jax(case):
    """Four steps from the same params, each with the same fresh gradients
    (scaled so the clip acts on some steps): params, m, v, master, step,
    lr and grad_norm after each."""
    dt, kw = CASES[case]
    cfg, jcfg = _configs(kw)
    rng = np.random.default_rng(0)
    p0 = _tree(lambda s: rng.normal(size=s).astype(np.float32))
    jp = jax.tree.map(lambda a: jnp.asarray(a, _jdt(dt)), p0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jstate, tstate = jopt.adamw_init(jp, jcfg), opt.adamw_init(tp, cfg)
    bf16_p = dt == torch.bfloat16 and not (cfg.master_fp32 and cfg.math_dtype == torch.float32)
    bf16_s = cfg.state_dtype == torch.bfloat16 or cfg.math_dtype == torch.bfloat16
    for step in range(4):
        scale = 0.05 if step % 2 else 3.0
        g0 = _tree(lambda s: (scale * rng.normal(size=s)).astype(np.float32))
        jg = jax.tree.map(lambda a: jnp.asarray(a, _jdt(dt)), g0)
        tg = params_from_jax(jax.tree.map(np.asarray, jg))
        jp, jstate, jm = jopt.adamw_update(jp, jg, jstate, jcfg)
        tp, tstate, tm = opt.adamw_update(tp, tg, tstate, cfg)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        _close(tm["lr"], jm["lr"], bf16=False)
        _close(tm["grad_norm"], jm["grad_norm"], bf16=False)
        for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert t.dtype == dt
            _close(t, j, bf16_p)
        jflat = {jax.tree_util.keystr(k): v for k, v in
                 jax.tree_util.tree_flatten_with_path(jstate["params"])[0]}
        for path, t in _paths(tstate["params"]):
            _close(t, jflat[path], bf16_s and not path.endswith("['master']"))


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, pre + f"['{k}']")
    else:
        yield pre, tree


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("master", [True, False])
def test_state_defs_and_init_match_jax(dt, master):
    cfg = opt.OptConfig(master_fp32=master, state_dtype=torch.bfloat16)
    jcfg = jopt.OptConfig(master_fp32=master, state_dtype=jnp.bfloat16)
    defs = _tree(lambda s: PV(s, dt))
    got = opt.opt_state_defs(defs, cfg)
    keys = lambda t: sorted(p for p, _ in _paths(t))
    p0 = _tree(lambda s: np.ones(s, np.float32))
    jp = jax.tree.map(lambda a: jnp.asarray(a, _jdt(dt)), p0)
    want = jopt.adamw_init(jp, jcfg)
    init = opt.adamw_init(params_from_jax(jax.tree.map(np.asarray, jp)), cfg)
    jkeys = sorted(jax.tree_util.keystr(k) for k, _ in
                   jax.tree_util.tree_flatten_with_path(want["params"])[0])
    assert keys(got["params"]) == keys(init["params"]) == jkeys
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    for path, t in _paths(init["params"]):
        want_dt = torch.float32 if path.endswith("['master']") else torch.bfloat16
        assert t.dtype == want_dt
        assert bool((t == (1 if path.endswith("['master']") else 0)).all())
