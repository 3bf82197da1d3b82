"""The Table I programs fconv2d, fdotproduct and exp (``repro_torch.core.isa_kernels``)
on a one-lane machine on the CPU against the JAX package's programs on its
(1, 1) machine (an Auto-axis mesh, f64, run eagerly: the programs read
their stores back to the host, and each eager instruction compiles its own
``shard_map``, so the file runs them once) at the reference check's sizes,
and against numpy: within 1e-10 of both (``check_core``'s bound), with the
instruction records equal.  ``test_torch_core_programs_rows.py`` runs the other three."""
import numpy as np
import pytest

from repro.core import isa_kernels as jkernels
from repro_torch.core import isa_kernels
from repro_torch.testing import check_core as cc

import torch_core_jax as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

NAMES = ('fconv2d', 'fdotproduct', 'exp')


@pytest.fixture(scope="module")
def runs():
    return J.program_runs(NAMES)


def test_the_programs_are_the_references():
    assert set(isa_kernels.KERNELS) == set(jkernels.KERNELS)


@pytest.mark.parametrize("name", NAMES)
def test_program_equals_the_jax_machine(runs, name):
    _, got, _, want, _ = runs
    assert np.shape(got[name]) == np.shape(want[name])
    np.testing.assert_allclose(got[name], want[name], rtol=1e-10)


@pytest.mark.parametrize("name", NAMES)
def test_program_equals_numpy(runs, name):
    want = cc.program_oracles(cc.program_inputs(1))[name]
    np.testing.assert_allclose(runs[1][name], want, rtol=1e-10)


def test_program_records_equal_the_jax_machine(runs):
    *_, got, _, want = runs
    assert len(got) == len(want) > 50
    assert J.records(got) == J.records(want)
