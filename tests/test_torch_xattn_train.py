"""Training the cross-attention families (encdec: seamless-m4t-large-v2;
vlm: llama-3.2-vision-11b) through the port against the JAX package (CPU,
f32 smoke configs, the JAX initialiser's weights, contexts drawn as the
train launcher draws them): the loss and every gradient leaf against
``jax.grad`` (``ctx_proj`` and, for encdec, every ``encoder`` leaf among
them), with and without remat; three train steps with one and two
microbatches; the smoke weight files; the launch counts of a train step;
the launcher.  Serving is ``test_torch_xattn.py``.

Tolerances, as ``tests/test_torch_train.py`` states them: the loss within
rtol 1e-5, each gradient leaf within ``1e-4 |want| + 2e-5 max|want|``, the
train steps within ``testing/train_checks.py``'s limits."""
import dataclasses

import numpy as np
import pytest

from repro.launch import train as jtrain
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import step_context
from repro_torch.models import lm
from repro_torch.testing import train_checks as tc
from repro_torch.train import trainer
from test_torch_xattn import XATTN, _setup
import torch_jax_smoke as J


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", XATTN)
def test_forward_train_loss_and_every_grad_leaf_match_jax(name, remat):
    """On 2 x 24 tokens with their contexts: under remat each period is a
    checkpoint with the context among its arguments, and each encoder
    layer one too, so a context cut off from autograd would leave
    ``ctx_proj`` and the encoder without gradients."""
    jcfg, cfg, jp, tp = _setup(name, remat=remat)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ctx = step_context(cfg, 0, 2, 24)
    J.assert_grads_match_jax(jcfg, cfg, jp, tp, toks, ctx=ctx)


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("name", XATTN)
def test_train_steps_match_jax(name, n_microbatches):
    """Three ``make_train_step`` steps from the JAX initialiser's weights
    against JAX's on the same batches and contexts (each split across the
    microbatches in order)."""
    got = tc.run_smoke("cpu", steps=3, n_microbatches=n_microbatches, arch=name)
    res = tc.compare_runs(got, J.jax_smoke_run(name, 3, n_microbatches), arch=name)
    assert res["ok"], res
    assert res["held"] == "run"


@pytest.mark.parametrize("name", XATTN)
def test_smoke_weights_files_are_the_jax_init(name):
    J.assert_weights_file_is_the_jax_init(name)


@pytest.mark.parametrize("name", XATTN)
def test_step_context_is_the_reference_launchers(name, monkeypatch):
    """The launcher's context for a step: ``default_rng(step).normal(size=(B,
    context_len, d_ctx)) * 0.1`` in f32, the bits the reference's launcher
    feeds its step."""
    cfg = get_smoke_config(name)
    seen = []
    jfn = jtrain.make_train_step

    def spy(*a, **kw):
        step = jfn(*a, **kw)

        def wrapped(state, batch):
            seen.append(np.asarray(batch["ctx"]))
            return step(state, batch)
        return wrapped
    monkeypatch.setattr(jtrain, "make_train_step", spy)
    monkeypatch.setattr(jtrain.jax, "jit", lambda f, **kw: f)
    jtrain.run(name, smoke=True, steps=2, global_batch=2, seq_len=16, log_every=10)
    assert len(seen) == 2
    for step, want in enumerate(seen):
        got = step_context(cfg, step, 2, 16)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("name", XATTN)
def test_step_launches_is_the_count_of_a_train_step(monkeypatch, name,
                                                    n_microbatches, remat):
    """A norm, 4 products and a flash attention a cross-attention sublayer
    (the context's rows need their dX), 2 norms, 7 products and a flash
    attention an encoder layer and the encoder's final norm, forward,
    remat and backward."""
    cfg = dataclasses.replace(get_smoke_config(name), remat=remat)
    assert J.count_train_step(monkeypatch, cfg, n_microbatches) == \
        trainer.step_launches(cfg, n_microbatches)


def test_step_launches_at_the_chip_cuts():
    """seamless whole under remat: 24 (attention, cross-attention, MLP)
    layers and 24 encoder layers; llama-3.2-vision at 2 of its 8 periods:
    8 self-attention, 2 cross-attention, 10 MLP sublayers."""
    s2s = get_config("seamless-m4t-large-v2")
    R, P, F = 3 * 24 + 2 * 24, 11 * 24 + 7 * 24, 2 * 24 + 24
    assert trainer.step_launches(s2s) == {
        "rmsnorm": 2 * R + 2, "matmul": 2 * P, "flash_attention": 2 * F,
        "rmsnorm_bwd": R + 2, "matmul_bwd": 2 * P, "flash_attention_bwd": F}
    vlm = dataclasses.replace(get_config("llama-3.2-vision-11b"), n_layers=10)
    R, P, F = 20, 4 * 8 + 3 * 10 + 4 * 2, 10
    assert trainer.step_launches(vlm) == {
        "rmsnorm": 2 * R + 1, "matmul": 2 * P, "flash_attention": 2 * F,
        "rmsnorm_bwd": R + 1, "matmul_bwd": 2 * P, "flash_attention_bwd": F}


@pytest.mark.parametrize("name", XATTN)
def test_train_launcher_trains_the_family_on_the_cpu(name):
    """``launch.train`` two steps with two microbatches through its
    ``main``: finite losses."""
    from repro_torch.launch import train
    out = train.run(name, steps=2, global_batch=2, seq_len=16, n_microbatches=2,
                    device="cpu")
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    train.main(["--arch", name, "--device", "cpu", "--steps", "1", "--batch", "2",
                "--seq", "16"])
    assert lm.context_len(get_smoke_config(name), 16) > 0
