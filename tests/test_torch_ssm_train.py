"""Training the Mamba2 family (mamba2-370m, and the jamba hybrid) through
the port against the JAX package (CPU, f32 smoke configs, the JAX
initialiser's weights): the loss and every gradient leaf against
``jax.grad``, train steps with one and two microbatches, the launch counts
of a train step and of a serving run, and the launchers.  The forward,
serving and SSD checks are ``test_torch_ssm.py``."""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention, matmul, ops, rmsnorm
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.testing import train_checks as tc
from repro_torch.train import trainer
from test_torch_ssm import SSM, _drive, _setup
import torch_jax_smoke as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


# ---------------------------------------------------------------------------
# training and launch counts
# ---------------------------------------------------------------------------
#
# Tolerances: mamba2 as ``tests/test_torch_train.py`` states them (the loss
# within rtol 1e-5, each gradient leaf within ``1e-4 |want| + 2e-5
# max|want|``, train steps within ``testing/train_checks.py``'s limits);
# jamba's gradient leaves within ``1e-4 |want| + 1e-4 max|want|`` and its
# train steps held at their start (``train_checks.START_ONLY``, which says
# why).

#: (arch, config overrides, gradient tolerance)
GRAD_CASES = {
    "mamba2": ("mamba2-370m", {}, J.GRAD_TOL),
    "mamba2-remat": ("mamba2-370m", {"remat": True}, J.GRAD_TOL),
    "mamba2-chunk-published": ("mamba2-370m", {"ssm_chunk": 256}, J.GRAD_TOL),
    "jamba": ("jamba-1.5-large-398b", {}, tc.START_ONLY["jamba-1.5-large-398b"]),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_forward_train_loss_and_every_grad_leaf_match_jax(case):
    """At the smoke chunk of 8 (four chunks of 32 tokens), under remat, and
    at the published chunk of 256 (one chunk), where the reference's
    gradient stays finite because the segment sums of 32 tokens do not
    overflow."""
    name, over, tol = GRAD_CASES[case]
    jcfg, cfg, jp, tp = _setup(name, **over)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    J.assert_grads_match_jax(jcfg, cfg, jp, tp, toks, grad_tol=tol)


@pytest.mark.parametrize("name", SSM)
def test_smoke_weights_files_are_the_jax_init(name):
    J.assert_weights_file_is_the_jax_init(name)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("name", SSM)
def test_step_launches_is_the_count_of_a_train_step(monkeypatch, name,
                                                    n_microbatches, remat):
    """Two norms and two products a Mamba sublayer (with jamba's attention,
    MLP and MoE sublayers), forward, remat and backward."""
    cfg = dataclasses.replace(get_smoke_config(name), remat=remat)
    assert J.count_train_step(monkeypatch, cfg, n_microbatches) == \
        trainer.step_launches(cfg, n_microbatches)


def test_launch_formulas_at_mamba2s_published_size():
    """48 Mamba sublayers: 97 norms and 96 products a forward; the train
    step under remat doubles the periods' forward."""
    cfg = get_config("mamba2-370m")
    assert trainer.step_launches(cfg) == {
        "rmsnorm": 193, "matmul": 192, "flash_attention": 0,
        "rmsnorm_bwd": 97, "matmul_bwd": 192, "flash_attention_bwd": 0}
    got = trainer.serve_launches(cfg, prefills=8, decode_steps=30)
    assert {k: v for k, v in got.items() if v} == {"rmsnorm": 97 * 38,
                                                    "matmul": 96 * 38}


def _serve_counting(monkeypatch) -> dict:
    """Calls of the Functions whose calls launch the forward kernels."""
    counts = dict.fromkeys(ops.LAUNCHES, 0)
    for cls, key in ((rmsnorm.RMSNorm, "rmsnorm"), (matmul.Matmul, "matmul"),
                     (flash_attention.FlashAttention, "flash_attention")):
        orig = cls.forward

        def wrapped(ctx, *a, _orig=orig, _key=key):
            counts[_key] += 1
            return _orig(ctx, *a)
        monkeypatch.setattr(cls, "forward", staticmethod(wrapped))
    return counts


@pytest.mark.parametrize("name", SSM)
def test_serve_launches_is_the_count_of_a_serving_run(monkeypatch, name):
    cfg = get_smoke_config(name)
    _, _, _, tp = _setup(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(5, 20))).astype(np.int32)
               for _ in range(6)]
    counts = _serve_counting(monkeypatch)
    eng = ServingEngine(lm.Model(cfg, tp), ServeConfig(max_batch=4, max_seq=64),
                        device="cpu")
    _drive(eng, prompts, new=6)
    tm = eng.timing
    assert counts == trainer.serve_launches(cfg, tm["prefills"], tm["decode_steps"])


@pytest.mark.parametrize("name", SSM)
def test_launchers_run_the_family_on_the_cpu(name):
    """``launch.train`` a step with two microbatches, ``launch.serve`` two
    requests, each through its ``main``."""
    from repro_torch.launch import serve, train
    train.main(["--arch", name, "--device", "cpu", "--steps", "1", "--batch", "2",
                "--seq", "16", "--microbatches", "2"])
    done = serve.main(["--arch", name, "--device", "cpu", "--requests", "2",
                       "--max-new", "3"])
    assert len(done) == 2 and all(len(r.out) == 3 for r in done)
