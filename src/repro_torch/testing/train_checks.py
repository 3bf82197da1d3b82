"""The smoke training step on two devices, and how far apart they may be.

``chip_smoke.py`` (phase 4b) runs the smoke models of ``SMOKE_ARCHS`` (f32)
from the JAX initialiser's weights (``weights_path(arch)``: llama3-8b's
written by ``scripts/make_torch_smoke_weights.py``, the MoE, Mamba and
cross-attention archs' by ``tests/torch_jax_smoke.py``) on the card through
the kernels and on the CPU through the plain versions, and holds the one
against the other; ``tests/test_torch_train.py``, ``test_torch_moe.py``,
``test_torch_ssm_train.py`` and ``test_torch_xattn_train.py`` hold the CPU
path against the JAX package with the same limits.  The encdec and vlm
archs' batches carry a context, drawn as the train launcher draws it
(``launch.train.step_context``).

Limits, f32 on both sides, sums in other orders:
  * the loss and the gradient's norm: rtol 1e-5 (measured ~1e-7);
  * each gradient leaf: ``|d| <= 1e-4 |want| + 2e-5 max|want|`` (the
    largest differences measured are ~2e-6 of the leaf's largest element);
  * params after the steps: Adam divides each gradient element by the root
    of its own second moment, so an element whose gradient is as small as
    the two sides' difference (~1e-6) takes an update of another size, up
    to lr a step.  So 99.9 % of the elements within 2e-6 (measured <= 7e-7)
    and every element within 1e-3 (a third of a step at the peak lr of
    3e-3; measured <= 4e-4).  A missing weight decay moves every element by
    ~3e-5 and fails the first;
  * m and v after the steps: within 5e-4 of the leaf's largest element
    (measured <= 1.2e-4).

jamba's smoke model (16 layers, 8 of them MoE, a gradient norm of ~95 at
its start) is held at its start only (``START_ONLY``): the loss and every
gradient leaf at the initial weights, within ``|d| <= 1e-4 |want| + 1e-4
max|want|``, and the first step's loss, gradient norm and lr.  Its
gradient in f32 lies ~3e-5 (the port) and ~5e-5 (the JAX package) of the
leaf's largest element from the port's f64 gradient, so two f32 runs
differ by up to that sum.  Its trajectory does not stay within rounding
of itself: Adam moves an element whose gradient is at that level by up to
lr, router weights among them, the next step's routing flips on near
ties, and the two f32 runs and the f64 one part by ~1e-3 in the third
step's loss.  Its later readings are printed, not held.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.launch.train import step_context
from repro_torch.models.lm import CONTEXT_FAMILIES
from repro_torch.params import params_from_dotted, tree_leaves, tree_map
from repro_torch.train import OptConfig, TrainState, adamw_init, make_train_step
from repro_torch.train.trainer import loss_and_grads, trainable

ARCH = "llama3-8b"
#: the archs whose smoke train step phase 4b holds card against CPU: the
#: dense family's, the MoE family's, mamba2's, the jamba hybrid's and the
#: cross-attention families' (encdec, vlm)
SMOKE_ARCHS = (ARCH, "mixtral-8x7b", "qwen3-moe-235b-a22b", "mamba2-370m",
               "jamba-1.5-large-398b", "seamless-m4t-large-v2",
               "llama-3.2-vision-11b")


#: archs whose smoke tree has another arch's shapes, so that JAX's init at
#: key 0 gives them the same weights: they read that arch's file
SAME_WEIGHTS = {"qwen3-moe-235b-a22b": "mixtral-8x7b"}


def weights_path(arch: str = ARCH) -> pathlib.Path:
    """The JAX initialiser's smoke weights of ``arch`` at key 0 (npz)."""
    arch = SAME_WEIGHTS.get(arch, arch)
    return pathlib.Path(__file__).with_name(f"{arch}-smoke-jax-seed0.npz")


SMOKE_WEIGHTS = weights_path(ARCH)
#: the launcher's optimizer at 3 steps: lr 3e-3, warmup 2
LR, WARMUP = 3e-3, 2
SCALAR_RTOL = 1e-5
GRAD_TOL = (1e-4, 2e-5)              # rtol, atol as a share of the leaf's max
PARAM_P999, PARAM_MAX = 2e-6, 1e-3
STATE_TOL = 5e-4                     # of the leaf's max
#: the archs held at their start only, with their gradient tolerance
START_ONLY = {"jamba-1.5-large-398b": (1e-4, 1e-4)}


def smoke_params(arch: str = ARCH) -> dict:
    """The JAX initialiser's smoke weights as a tree on the CPU."""
    with np.load(weights_path(arch)) as flat:
        return params_from_dotted({k: flat[k] for k in flat.files})


def smoke_batches(steps: int, batch: int = 4, seq: int = 32, seed: int = 0,
                  arch: str = ARCH):
    cfg = get_smoke_config(arch)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch, seed=seed))
    return [corpus.batch(s) for s in range(steps)]


def smoke_contexts(steps: int, batch: int = 4, seq: int = 32, arch: str = ARCH):
    """Each step's context (numpy f32) for an encdec or vlm arch, as the
    train launcher draws it; None a step for the other archs."""
    cfg = get_smoke_config(arch)
    if cfg.family not in CONTEXT_FAMILIES:
        return [None] * steps
    return [step_context(cfg, s, batch, seq) for s in range(steps)]


def opt_config(steps: int) -> OptConfig:
    return OptConfig(lr=LR, warmup_steps=WARMUP, total_steps=steps)


def run_smoke(device, steps: int = 2, n_microbatches: int = 1,
              arch: str = ARCH, cfg=None) -> dict:
    """The loss and gradients at the initial weights, then ``steps`` train
    steps: metrics by step, and the params and optimizer state after.
    ``cfg`` replaces ``arch``'s smoke config (another capacity factor, say)
    with the same weights."""
    cfg = cfg or get_smoke_config(arch)
    params = trainable(tree_map(lambda t: t.to(device), smoke_params(arch)))
    batches = []
    for toks, ctx in zip(smoke_batches(steps, arch=arch),
                         smoke_contexts(steps, arch=arch)):
        b = {"tokens": torch.from_numpy(toks).to(device, torch.int64)}
        if ctx is not None:
            b["ctx"] = torch.from_numpy(ctx).to(device)
        batches.append(b)
    loss0, grads0 = loss_and_grads(params, batches[0]["tokens"], cfg,
                                   batches[0].get("ctx"))
    opt_cfg = opt_config(steps)
    state = TrainState(params, adamw_init(params, opt_cfg))
    step = make_train_step(cfg, opt_cfg, n_microbatches=n_microbatches)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss0": float(loss0), "grads0": grads0, "metrics": metrics,
            "params": state.params, "opt": state.opt}


def _flat(tree) -> list:
    return [t.detach().float().cpu() for t in tree_leaves(tree)]


def compare_runs(got: dict, want: dict, arch: str = ARCH) -> dict:
    """Readings of ``got`` against ``want`` (two :func:`run_smoke` results
    of ``arch``), each beside its limit, and ``ok``; ``held`` says whether
    the whole run is held or, for an arch of ``START_ONLY``, its start."""
    res = {}
    whole = arch not in START_ONLY
    grad_tol = START_ONLY.get(arch, GRAD_TOL)
    steps = list(zip(got["metrics"], want["metrics"]))
    scal = [(got["loss0"], want["loss0"])] + [
        (g[k], w[k]) for g, w in (steps if whole else steps[:1])
        for k in ("loss", "grad_norm", "lr")]
    res["held"] = "run" if whole else "start"
    res["scalar_rel"] = max(abs(a - b) / max(abs(b), 1e-30) for a, b in scal)
    g_use = 0.0
    for a, b in zip(_flat(got["grads0"]), _flat(want["grads0"])):
        lim = grad_tol[0] * b.abs() + grad_tol[1] * b.abs().max()
        g_use = max(g_use, float(((a - b).abs() / lim.clamp_min(1e-30)).max()))
    res["grad_limit_use"] = g_use
    d = torch.cat([(a - b).abs().ravel() for a, b in
                   zip(_flat(got["params"]), _flat(want["params"]))])
    res["param_p999"] = float(torch.quantile(d, 0.999))
    res["param_max"] = float(d.max())
    res["state_rel"] = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                           for a, b in zip(_flat(got["opt"]["params"]),
                                           _flat(want["opt"]["params"])))
    res["same_step"] = int(got["opt"]["step"]) == int(want["opt"]["step"])
    res["finite"] = all(bool(torch.isfinite(t).all()) for t in _flat(got["params"]))
    res["ok"] = (res["scalar_rel"] <= SCALAR_RTOL and g_use <= 1.0
                 and (not whole or (res["param_p999"] <= PARAM_P999
                                    and res["param_max"] <= PARAM_MAX
                                    and res["state_rel"] <= STATE_TOL))
                 and res["same_step"] and res["finite"])
    return res
