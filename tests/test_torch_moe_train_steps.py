"""Train steps of the MoE family (mixtral-8x7b, and qwen3-moe at a binding
capacity factor) through the port against the JAX package (CPU, f32 smoke
configs, the JAX initialiser's weights), with one and two microbatches,
within ``testing/train_checks.py``'s limits.  Apart from
``test_torch_moe.py`` so that each file fits a worker's share of the
suite."""
import dataclasses

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.testing import train_checks as tc
from test_torch_moe import GRAD_CASES
import torch_jax_smoke as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("case", ["mixtral", "qwen3-binding"])
def test_train_steps_match_jax(case, n_microbatches):
    """Three ``make_train_step`` steps from the JAX initialiser's weights
    (``testing/train_checks.py``) against JAX's on the same batches.  With
    two microbatches the batch splits before routing, as in the reference:
    at the binding factor each microbatch's capacity counts its own rows."""
    name, over = GRAD_CASES[case]
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    got = tc.run_smoke("cpu", steps=3, n_microbatches=n_microbatches, arch=name,
                       cfg=cfg)
    res = tc.compare_runs(got, J.jax_smoke_run(name, 3, n_microbatches, **over),
                          arch=name)
    assert res["ok"] and res["held"] == "run", res
