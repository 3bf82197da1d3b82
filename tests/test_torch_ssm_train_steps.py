"""Train steps of the Mamba2 family (mamba2-370m, and the jamba hybrid)
through the port against the JAX package (CPU, f32 smoke configs, the JAX
initialiser's weights), with one and two microbatches, within
``testing/train_checks.py``'s limits; jamba held at its start
(``train_checks.START_ONLY``).  Apart from ``test_torch_ssm_train.py`` (the
gradients, launch counts and launchers) so that each file fits a worker's
share of the suite."""
import pytest

from repro_torch.testing import train_checks as tc
from test_torch_ssm import SSM
import torch_jax_smoke as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("name", SSM)
def test_train_steps_match_jax(name, n_microbatches):
    """Three ``make_train_step`` steps from the JAX initialiser's weights
    against JAX's on the same batches; jamba, held at its start, one (its
    later steps would be read and not held)."""
    steps = 1 if name in tc.START_ONLY else 3
    got = tc.run_smoke("cpu", steps=steps, n_microbatches=n_microbatches, arch=name)
    res = tc.compare_runs(got, J.jax_smoke_run(name, steps, n_microbatches),
                          arch=name)
    assert res["ok"], res
    assert res["held"] == ("start" if name in tc.START_ONLY else "run")
