"""Train steps of the cross-attention families (seamless-m4t-large-v2,
llama-3.2-vision-11b) through the port against the JAX package (CPU, f32
smoke configs, the JAX initialiser's weights, their contexts), with one and
two microbatches, within ``testing/train_checks.py``'s limits.  Apart from
``test_torch_xattn_train.py`` (the gradients, launch counts and launchers)
so that each file fits a worker's share of the suite."""
import pytest

from repro_torch.testing import train_checks as tc
from test_torch_xattn import XATTN
import torch_jax_smoke as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


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
