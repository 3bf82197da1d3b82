"""The port's training path against the JAX package's on the CPU: the
loss and every gradient leaf of ``forward_train``, the train step with and
without microbatches, the launcher, the data pipeline, and the launch
counts of a train step.

The same JAX-initialised weights (carried over with ``params_from_jax``)
and the same numpy tokens on both sides, f32 smoke configs, ``use_pallas``
off (the JAX package's CPU default).  Tolerances:
  * loss: rtol 1e-5 (f32 sums in other orders; measured <= 2e-7);
  * each gradient leaf: ``|d| <= 1e-4 |want| + 2e-5 max|want|`` (measured
    <= 1.5e-6 of the leaf's largest element);
  * after train steps, as ``testing/train_checks.py`` states them: 99.9 %
    of the params within 2e-6 and every one within 1e-3 (Adam's update of
    an element whose gradient is as small as the two sides' difference
    takes another size, up to lr a step), m and v within 5e-4 of their
    largest element, loss, lr and grad_norm within rtol 1e-5.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.launch import train as jlaunch
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules, init_params as jax_init
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, Pipeline, SyntheticCorpus, global_batch
from repro_torch.kernels import flash_attention, matmul, rmsnorm
from repro_torch.launch import train as launch
from repro_torch.models import lm
from repro_torch.params import params_from_jax, tree_leaves
from repro_torch.testing import train_checks as tc
from repro_torch.train import trainer
import torch_jax_smoke as J

RULES = default_rules(None)
LOSS_RTOL = 1e-5
GRAD_TOL = (1e-4, 2e-5)
CASES = {"llama3": ("llama3-8b", {}), "deepseek": ("deepseek-7b", {}),
         "glm4": ("glm4-9b", {}), "phi3": ("phi3-mini-3.8b", {}),
         "llama3-remat": ("llama3-8b", {"remat": True}),
         "llama3-loss-chunk": ("llama3-8b", {"loss_chunk": 8})}


def _setup(case):
    name, over = CASES[case]
    jcfg = dataclasses.replace(jax_smoke_config(name), **over)
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _paths(tree, pre=""):
    """(JAX key path, leaf) of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, pre + f"['{k}']")
    else:
        yield pre, tree


def _jax_flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tokens(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_train_loss_and_every_grad_leaf_match_jax(case):
    """glm4 has 2 kv heads of 4 query heads, phi3 and deepseek full
    multi-head (2 of 2 in the smoke variants), one case remats each period
    and one chunks the loss."""
    jcfg, cfg, jp, tp = _setup(case)
    toks = _tokens(cfg)
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
                                   atol=GRAD_TOL[1] * np.abs(w).max(),
                                   err_msg=path)


@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_train_step_matches_jax(n_microbatches):
    """Three steps of ``make_train_step`` from the JAX initialiser's weights
    on the same batches: loss and gradients at the start, then loss, lr and
    grad_norm of each step, and the params and optimizer state after."""
    got = tc.run_smoke("cpu", steps=3, n_microbatches=n_microbatches)
    want = J.jax_smoke_run(tc.ARCH, 3, n_microbatches)
    res = tc.compare_runs(got, want)
    assert res["ok"], res


def test_smoke_weights_file_is_the_jax_init():
    """The weights phase 4b of chip_smoke.py trains from are
    ``init_params`` of the JAX smoke model at key 0, bit for bit."""
    jp = jax_init(jlm.model_defs(jax_smoke_config(tc.ARCH)), jax.random.key(0))
    want = _jax_flat(jp)
    got = dict(_paths(tc.smoke_params()))
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[path], err_msg=path)


def test_launcher_losses_equal_jax_run():
    """``launch.train.run`` on the CPU from the weights JAX's ``run`` draws
    (seed 0) gives its losses, step by step."""
    jout = jlaunch.run("llama3-8b", steps=3, log_every=100)
    jp = jax_init(jlm.model_defs(jax_smoke_config("llama3-8b")), jax.random.key(0))
    out = launch.run("llama3-8b", steps=3, device="cpu", log_every=100,
                     params=params_from_jax(jax.tree.map(np.asarray, jp)))
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=LOSS_RTOL)


def test_launcher_cli_trains_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16", "--microbatches", "2"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[train]")]
    assert "step     0" in lines[0] and "[cpu]" in lines[0]
    assert lines[-1].startswith("[train] done: first loss")


@pytest.mark.parametrize("flag", ["--ckpt=/tmp/x", "--chaos", "--procs"])
def test_launcher_refuses_what_it_does_not_take_yet(flag, capsys):
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--steps", "1", flag])
    assert "not ported yet" in capsys.readouterr().err


def test_launcher_refuses_the_card_where_there_is_none():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.run("llama3-8b", steps=1)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_pipeline_batches_match_jax(n_hosts):
    """The port's one-host batch is JAX's global batch, and every JAX host's
    shard of it in host order; the prefetching iterator gives steps 0, 1, 2
    in order."""
    kw = dict(vocab_size=512, seq_len=40, global_batch=8, seed=3)
    cfg = DataConfig(**kw)
    shards = [jpipe.SyntheticCorpus(jpipe.DataConfig(**kw, n_hosts=n_hosts,
                                                     host_id=h)).batch(2)
              for h in range(n_hosts)]
    np.testing.assert_array_equal(SyntheticCorpus(cfg).batch(2),
                                  np.concatenate(shards))
    np.testing.assert_array_equal(global_batch(cfg, 1),
                                  jpipe.global_batch(jpipe.DataConfig(**kw), 1))
    pipe = Pipeline(cfg)
    try:
        for step in range(3):
            np.testing.assert_array_equal(next(pipe),
                                          SyntheticCorpus(cfg).batch(step))
    finally:
        pipe.close()


def _counting(monkeypatch):
    """Counts of the three Functions' forward and backward calls: on the
    CPU they stand where the kernels launch on the card."""
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
                if _key == "matmul_bwd":    # one launch a product made
                    counts[_key] += sum(o is not None for o in out)
                else:
                    counts[_key] += 1
                return out
            monkeypatch.setattr(cls, attr, staticmethod(wrapped))
    return counts


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_step_launches_is_the_count_of_a_train_step(monkeypatch, remat,
                                                    n_microbatches):
    """``trainer.step_launches``'s formula against the calls a train step
    makes of the Functions whose calls launch the kernels on the card;
    under remat each period's forward runs again in the backward."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), remat=remat)
    counts = _counting(monkeypatch)
    state = trainer.init_train_state(cfg, tc.opt_config(1),
                                     torch.Generator().manual_seed(0), "cpu")
    step = trainer.make_train_step(cfg, tc.opt_config(1),
                                   n_microbatches=n_microbatches)
    step(state, {"tokens": torch.from_numpy(_tokens(cfg, B=2, S=12)).long()})
    want = trainer.step_launches(cfg, n_microbatches)
    assert counts == want
    # the formula at llama3-8b's 8-layer cut: 8 attention and 8 MLP sublayers
    full = dataclasses.replace(cfg, n_layers=8, remat=True)
    assert trainer.step_launches(full) == {
        "rmsnorm": 33, "matmul": 112, "flash_attention": 16,
        "rmsnorm_bwd": 17, "matmul_bwd": 112, "flash_attention_bwd": 8}


def test_serving_leaves_stay_frozen():
    """Serving keeps frozen leaves (no autograd on the serve paths); the
    trainer's ``trainable`` gives the same tensors as trainable leaves."""
    cfg = get_smoke_config("llama3-8b")
    params = tc.smoke_params()
    model = lm.Model(cfg, params)
    assert not any(p.requires_grad for p in model.parameters())
    leaves = tree_leaves(trainer.trainable(model.tree()))
    assert all(t.requires_grad and t.is_leaf for t in leaves)
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(leaves, tree_leaves(model.tree())))
    assert not any(p.requires_grad for p in model.parameters())
