"""Ring attention on a process mesh (gloo ranks on the CPU,
``testing/check_dist_ring.py``) against the JAX package's ``ref.attention``
at (2, 128, 4/2, 32) f32, causal, non-causal and with a window of 24, on
4 and 8 ranks: the flat ring and the hierarchical odometer (2 x 2 levels
at 4 ranks, 2 x 2 x 2 at 8) within 2e-4; hierarchical against flat within
``REASSOC_TOL``; ``schedule="db"`` bit-equal to ``"seq"``."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro_torch.testing import check_dist_ring as cdr
from repro_torch.testing.subproc import run_ranks

WORLDS = (4, 8)


@pytest.fixture(scope="module")
def runs():
    return {n: cdr.assemble(run_ranks("repro_torch.testing.check_dist_ring", n, str(n),
                                      device="cpu", timeout=300), n)
            for n in WORLDS}


@pytest.fixture(scope="module")
def want():
    q, k, v = (jnp.asarray(t.numpy()).transpose(0, 2, 1, 3)
               for t in cdr.inputs("smoke", "cpu"))
    return {c: np.asarray(jref.attention(q, k, v, causal=c[0], window=c[1])
                          .transpose(0, 2, 1, 3))
            for c in cdr.CASES["smoke"]}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", cdr.CASES["smoke"],
                         ids=lambda c: f"causal={c[0]}-window={c[1]}")
@pytest.mark.parametrize("ring", ["seq", "db", "hier"])
def test_ring_attention_matches_jax_reference(runs, want, n, case, ring):
    np.testing.assert_allclose(runs[n][case][ring].numpy(), want[case],
                               rtol=cdr.RTOL, atol=cdr.ATOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", cdr.CASES["smoke"],
                         ids=lambda c: f"causal={c[0]}-window={c[1]}")
def test_hierarchical_ring_reassociates_and_db_is_seq(runs, n, case):
    r = runs[n][case]
    assert r["db_same"]
    assert float((r["hier"] - r["seq"]).abs().max()) <= cdr.REASSOC_TOL
    # the hops moved K and V: n - 1 a turn of the flat ring, each one block
    assert all(st["bytes"] > 0 for st in r["stats"]["seq"])
