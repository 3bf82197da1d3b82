"""The smoke training step on two devices, and how far apart they may be.

``chip_smoke.py`` (phase 4b) runs the llama3-8b smoke model (f32) from the
JAX initialiser's weights (``SMOKE_WEIGHTS``, written by
``scripts/make_torch_smoke_weights.py``) on the card through the kernels
and on the CPU through the plain versions, and holds the one against the
other; ``tests/test_torch_train.py`` holds the CPU path against the JAX
package with the same limits.

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
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.params import params_from_dotted, tree_leaves, tree_map
from repro_torch.train import OptConfig, TrainState, adamw_init, make_train_step
from repro_torch.train.trainer import loss_and_grads, trainable

SMOKE_WEIGHTS = pathlib.Path(__file__).with_name("llama3-8b-smoke-jax-seed0.npz")
ARCH = "llama3-8b"
#: the launcher's optimizer at 3 steps: lr 3e-3, warmup 2
LR, WARMUP = 3e-3, 2
SCALAR_RTOL = 1e-5
GRAD_TOL = (1e-4, 2e-5)              # rtol, atol as a share of the leaf's max
PARAM_P999, PARAM_MAX = 2e-6, 1e-3
STATE_TOL = 5e-4                     # of the leaf's max


def smoke_params() -> dict:
    """The JAX initialiser's smoke weights as a tree on the CPU."""
    with np.load(SMOKE_WEIGHTS) as flat:
        return params_from_dotted({k: flat[k] for k in flat.files})


def smoke_batches(steps: int, batch: int = 4, seq: int = 32, seed: int = 0):
    cfg = get_smoke_config(ARCH)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch, seed=seed))
    return [corpus.batch(s) for s in range(steps)]


def opt_config(steps: int) -> OptConfig:
    return OptConfig(lr=LR, warmup_steps=WARMUP, total_steps=steps)


def run_smoke(device, steps: int = 2, n_microbatches: int = 1) -> dict:
    """The loss and gradients at the initial weights, then ``steps`` train
    steps: metrics by step, and the params and optimizer state after."""
    cfg = get_smoke_config(ARCH)
    params = trainable(tree_map(lambda t: t.to(device), smoke_params()))
    batches = [torch.from_numpy(b).to(device, torch.int64)
               for b in smoke_batches(steps)]
    loss0, grads0 = loss_and_grads(params, batches[0], cfg)
    opt_cfg = opt_config(steps)
    state = TrainState(params, adamw_init(params, opt_cfg))
    step = make_train_step(cfg, opt_cfg, n_microbatches=n_microbatches)
    metrics = []
    for b in batches:
        state, m = step(state, {"tokens": b})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss0": float(loss0), "grads0": grads0, "metrics": metrics,
            "params": state.params, "opt": state.opt}


def _flat(tree) -> list:
    return [t.detach().float().cpu() for t in tree_leaves(tree)]


def compare_runs(got: dict, want: dict) -> dict:
    """Readings of ``got`` against ``want`` (two :func:`run_smoke` results),
    each beside its limit, and ``ok``."""
    res = {}
    scal = [(got["loss0"], want["loss0"])] + [
        (g[k], w[k]) for g, w in zip(got["metrics"], want["metrics"])
        for k in ("loss", "grad_norm", "lr")]
    res["scalar_rel"] = max(abs(a - b) / max(abs(b), 1e-30) for a, b in scal)
    g_use = 0.0
    for a, b in zip(_flat(got["grads0"]), _flat(want["grads0"])):
        lim = GRAD_TOL[0] * b.abs() + GRAD_TOL[1] * b.abs().max()
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
                 and res["param_p999"] <= PARAM_P999
                 and res["param_max"] <= PARAM_MAX
                 and res["state_rel"] <= STATE_TOL and res["same_step"]
                 and res["finite"])
    return res
