"""``test_torch_dist_train.py``'s checks for mixtral's smoke model: its
MoE sublayers in ep mode on the mesh (4 experts: 2 a rank on (2, 2), one
on (1, 4)), its window of 16 over 32-token sequences; the loss and every
gradient leaf against ``jax.grad``, three steps against JAX's, the
bucketed sync, the mesh's gradient norm and each rank's kernel calls
(``step_launches`` with the mesh: 3 products for each of the rank's
experts)."""
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.parallel.comm import Mesh
from repro_torch.parallel.sharding import default_rules
from repro_torch.testing import check_dist_train as cdt
from repro_torch.train.trainer import step_launches
from test_torch_dist_train import (MESHES, check_run, check_sync_norm_and_launches,
                                   jax_runs, ranks_of)
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

ARCH = "mixtral-8x7b"


@pytest.fixture(scope="module")
def dirs():
    return ranks_of(ARCH)


@pytest.fixture(scope="module")
def want():
    return jax_runs(ARCH)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("n", cdt.MICRO)
def test_sharded_moe_train_step_matches_jax(dirs, want, mesh, n):
    check_run(dirs, want, ARCH, mesh, n)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_bucketed_sync_global_norm_and_launches(dirs, want, mesh):
    check_sync_norm_and_launches(dirs, want, ARCH, mesh)


@pytest.mark.parametrize("m,experts", [(1, 4), (2, 2), (4, 1)])
def test_step_launches_counts_the_ranks_experts(m, experts):
    """Each MoE sublayer runs 3 products for each of the rank's experts
    (E/|model| in ep), forward and (2 each) backward; off-mesh all E."""
    cfg = get_smoke_config(ARCH)
    rules = default_rules(Mesh.abstract((1, m), ("data", "model")))
    base = step_launches(cfg)
    got = step_launches(cfg, 1, rules)
    moe = cfg.n_layers                       # one MoE sublayer a layer
    assert base["matmul"] - got["matmul"] == 3 * moe * (cfg.n_experts - experts)
    assert base["matmul_bwd"] - got["matmul_bwd"] == 6 * moe * (cfg.n_experts - experts)
    assert {k: v for k, v in got.items() if "matmul" not in k} == \
        {k: v for k, v in base.items() if "matmul" not in k}
