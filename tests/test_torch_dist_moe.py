"""The MoE sublayer on a process mesh (gloo ranks on the CPU,
``testing/check_dist_moe.py``) against the JAX package's single-device
layer: qwen3-moe's smoke sublayer with 8 experts, top-2, capacity factor 8
in ep and ep_a2a, and mixtral's with ``moe_tp`` in tp, on (2, 2) and
(1, 4) meshes of 4 ranks and a (2, 4) mesh of 8; the output and the
gradients of x and of every weight (under a fixed cotangent) within the
reference check's rtol/atol of 2e-4; the hierarchical all-to-all (2 x 2
levels at 4 ranks, 2 x 2 x 2 at 8) bit-equal to the one-stage exchange and
to the flat exchange over one `model` dimension."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.parallel.sharding import default_rules as jax_rules
from repro_torch.testing import check_dist_moe as cdm
from repro_torch.testing.subproc import run_ranks
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

MESHES = [(2, 2), (1, 4), (2, 4)]
KEYS = [(name, mode) for name in cdm.SMOKE for mode in cdm.SMOKE[name][2]]


@pytest.fixture(scope="module")
def runs():
    """Each mesh's ranks, put together."""
    out = {}
    for nd, nm in MESHES:
        d = run_ranks("repro_torch.testing.check_dist_moe", nd * nm, str(nd), str(nm),
                      device="cpu", timeout=300)
        out[(nd, nm)] = cdm.assemble(d, nd * nm, "smoke")
    return out


@pytest.fixture(scope="module")
def want():
    """The JAX layer's output and gradients on each case's inputs."""
    out = {}
    for name, (arch, over, _) in cdm.SMOKE.items():
        cfg, _, params, x, cot = cdm.inputs(name, "smoke", "cpu")
        jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
        jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
        jx, jcot = jnp.asarray(x.numpy()), jnp.asarray(cot.numpy())
        f = lambda p, x: JL.moe_layer(p, x, jcfg, jax_rules(None))
        y, vjp = jax.vjp(f, jp, jx)
        dp, dx = vjp(jcot)
        out[name] = {"y": np.asarray(y), "dx": np.asarray(dx),
                     "dp": {k: np.asarray(v) for k, v in dp.items()}}
    return out


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=cdm.RTOL, atol=cdm.ATOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]}-{k[1]}")
def test_moe_mode_matches_the_jax_layer(runs, want, mesh, key):
    got, w = runs[mesh][key], want[key[0]]
    _close(got["y"], w["y"])
    _close(got["dx"], w["dx"])
    assert set(got["dp"]) == set(w["dp"])
    for k in w["dp"]:
        _close(got["dp"][k], w["dp"][k])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_hierarchical_a2a_is_bit_equal_to_the_flat_exchange(runs, want, mesh):
    h = runs[mesh]["hier"]
    assert h["levels"] == ((2, 2, 2) if mesh[0] * mesh[1] == 8 else (2, 2))
    assert h["all_ranks_same"]
    _close(h["y"], want[h["name"]]["y"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_collectives_are_counted(runs, mesh):
    """ep_a2a moves the capacity buffers (two all-to-alls a stage, and the
    gather of the slices); every rank counted its bytes and host time."""
    for key in KEYS:
        assert all(st["bytes"] > 0 and st["collective_ms"] > 0
                   for st in runs[mesh][key]["stats"])
