"""The chaos harness on real ranks (``testing/check_chaos.py --mesh``: 8
gloo ranks on the CPU, a (4, 2) ``(data, model)`` mesh) against the JAX
package's ``run_chaos`` on 8 fake devices, with the reference check's
geometry and schedule (``check_chaos.CHAOS_SPEC``: a transient straggler,
a torn checkpoint, host 0 killed).  Held:
  * the port's own assertions on every rank (``check_chaos.check_mesh``):
    one restart onto the (2, 2) survivor mesh of ranks 4-7 from the
    step-4 checkpoint, host 0's ranks leaving at the detection step;
  * the restart log, timeline, fingerprints, steps executed, virtual
    seconds and final mesh equal to JAX's;
  * the steps before the restore within f32's limits of JAX's
    (``LOSS_RTOL`` = 1e-5, the one-device test's); the steps after it
    within the reference check's own ``POST_RESCALE_RTOL`` /
    ``POST_RESCALE_ATOL`` (both sides recompute the tail on a smaller
    mesh, in other orders);
  * ``rescale_rules``' survivor mesh is a group of the surviving ranks."""
import numpy as np
import pytest

from repro.launch import train as jlaunch
from repro.testing.x64 import x64_mode
from repro_torch.testing import check_chaos
from repro_torch.testing.subproc import run_ranks
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

LOSS_RTOL = 1e-5
SAME = ("restarts", "n_restarts", "timeline", "fingerprints", "steps_executed",
        "virtual_seconds", "final_mesh_shape", "chaos_spec")


@pytest.fixture(scope="module")
def runs():
    d = run_ranks("repro_torch.testing.check_chaos", check_chaos.MESH_RANKS, "--mesh",
                  device="cpu", timeout=300)
    return check_chaos.assemble(d)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = {}
    for name, spec in (("ref", ""), ("chaos", check_chaos.CHAOS_SPEC)):
        with x64_mode(False):
            out[name] = jlaunch.run_chaos(
                chaos_spec=spec, ckpt_dir=str(tmp_path_factory.mktemp(name)),
                verbose=False, **check_chaos.COMMON)
    return out


def test_check_chaos_mesh_passes_on_every_rank(runs):
    out = check_chaos.check_mesh(runs)
    assert out["chaos"]["restarts"][0]["new_mesh_shape"] == [2, 2]


@pytest.mark.parametrize("name", ["ref", "chaos"])
def test_records_equal_jax(runs, jax_runs, name):
    got = [r for r in runs[name] if r["left_at_step"] is None][-1]
    for k in SAME:
        assert got[k] == jax_runs[name][k], k


@pytest.mark.parametrize("name", ["ref", "chaos"])
def test_losses_match_jax(runs, jax_runs, name):
    got = [r for r in runs[name] if r["left_at_step"] is None][-1]
    want = jax_runs[name]
    rstep = want["restarts"][0]["restore_step"] if want["restarts"] else len(want["losses"])
    np.testing.assert_allclose(got["losses"][:rstep], want["losses"][:rstep],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"][rstep:], want["losses"][rstep:],
                               rtol=check_chaos.POST_RESCALE_RTOL,
                               atol=check_chaos.POST_RESCALE_ATOL)


def test_lost_ranks_leave_at_the_detection_step(runs):
    chaos = runs["chaos"]
    left = [r["left_at_step"] for r in chaos]
    step = [r for r in chaos if r["left_at_step"] is None][0]["restarts"][0][
        "detected_at_step"]
    assert left == [step] * 4 + [None] * 4
