"""The sharded train step on a process mesh (gloo ranks on the CPU,
``testing/check_dist_train.py``) against the JAX package: llama3-8b's smoke
model (kv 2: a `model` of 4 cuts through heads) on (2, 2) and (1, 4)
meshes, from the JAX initialiser's weights on ``train_checks``' batches.
The ranks' blocks gathered (``gather_tree``): the loss and every gradient
leaf at the start against ``jax.grad`` of the single-device model, three
steps with 1 and 2 microbatches against JAX's three steps (the limits of
``train_checks.compare_runs``); the bucketed gradient sync bit-equal to
the unbucketed one; ``global_norm`` on the mesh equal to the one-device
norm; each rank's kernel calls a step equal to ``step_launches``.
``test_torch_dist_train_moe.py`` runs mixtral's smoke model the same way."""
import numpy as np
import pytest

from repro_torch.testing import check_dist_train as cdt
from repro_torch.testing import train_checks as tc
from repro_torch.testing.subproc import run_ranks
from repro_torch.train import global_norm
import torch_jax_smoke as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

ARCH = "llama3-8b"
MESHES = [(2, 2), (1, 4)]


def ranks_of(arch: str) -> dict:
    """Each mesh's run directory for ``arch``."""
    return {(nd, nm): run_ranks("repro_torch.testing.check_dist_train", nd * nm,
                                str(nd), str(nm), "--archs", arch, device="cpu",
                                timeout=300)
            for nd, nm in MESHES}


def jax_runs(arch: str) -> dict:
    return {n: J.jax_smoke_run(arch, cdt.STEPS, n) for n in cdt.MICRO}


def check_run(dirs, want, arch, mesh, n) -> None:
    nd, nm = mesh
    got = cdt.assemble(dirs[mesh], nd * nm, arch, n)
    res = tc.compare_runs(got, want[n], arch)
    assert res["ok"], res


def check_sync_norm_and_launches(dirs, want, arch, mesh) -> None:
    nd, nm = mesh
    for n in cdt.MICRO:
        got = cdt.assemble(dirs[mesh], nd * nm, arch, n)
        assert all(got["bucket_same"]), got["bucket_same"]
        assert got["same_metrics_on_every_rank"]
        assert all(c == got["want_launches"] for c in got["launches"]), got["launches"]
    one = float(global_norm(want[1]["grads0"]))
    assert all(abs(g - one) <= tc.SCALAR_RTOL * one for g in got["gnorm0"]), \
        (got["gnorm0"], one)


@pytest.fixture(scope="module")
def dirs():
    return ranks_of(ARCH)


@pytest.fixture(scope="module")
def want():
    return jax_runs(ARCH)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("n", cdt.MICRO)
def test_sharded_train_step_matches_jax(dirs, want, mesh, n):
    check_run(dirs, want, ARCH, mesh, n)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_bucketed_sync_global_norm_and_launches(dirs, want, mesh):
    check_sync_norm_and_launches(dirs, want, ARCH, mesh)


def test_fsdp_leaves_come_back_reduce_scattered():
    """On (2, 2) a period leaf is cut over `data` (fsdp) and `model`: its
    block and its gradient are a quarter of the leaf; the embedding (cut
    over `model` only) is half of it."""
    from repro_torch.models import lm
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules, local_shape, param_placements

    cfg = cdt.config(ARCH, "smoke")
    mesh = Mesh.abstract((2, 2), ("data", "model"))
    rules = default_rules(mesh, batch=cdt.BATCH)
    defs = lm.model_defs(cfg)
    specs = param_placements(defs, rules)
    wq = defs["period"]["l0"]["s0_attn"]["wq"]
    assert specs["period"]["l0"]["s0_attn"]["wq"] == ((), ("data",), ("model",))
    assert local_shape(wq.shape, specs["period"]["l0"]["s0_attn"]["wq"], mesh) == \
        (wq.shape[0], wq.shape[1] // 2, wq.shape[2] // 2)
    assert specs["embed"] == (("model",), ())
    assert np.prod(local_shape(defs["embed"].shape, specs["embed"], mesh)) * 2 == \
        np.prod(defs["embed"].shape)


def test_a_batch_whole_over_the_fsdp_dimensions_is_refused():
    """default_rules leaves a batch that does not divide over `data` whole
    on every rank; the ZeRO-3 gathers would then sum its gradient twice."""
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules
    from repro_torch.train import make_train_step

    cfg = cdt.config(ARCH, "smoke")
    rules = default_rules(Mesh.abstract((2, 2), ("data", "model")), batch=3)
    with pytest.raises(ValueError, match="must cut the batch too"):
        make_train_step(cfg, cdt.opt_config("smoke"), rules=rules)
