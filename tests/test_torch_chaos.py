"""The port's chaos-tested elastic training (``launch.train.run_chaos``) and
checkpointed ``run`` against the JAX package's, on the CPU.

The reference runs ``run_chaos`` on its 8 fake devices, as
``tests/test_chaos.py`` does; the port runs it on one device over 8
logical ones, from the same JAX-initialised weights (``params_from_jax``)
and the same batches.  Held:
  * restarts, timeline, fingerprints, ``steps_executed``,
    ``virtual_seconds`` and the final mesh: equal;
  * losses: rtol ``LOSS_RTOL`` = 1e-5 (f32 sums in other orders and on
    other meshes; measured <= 2e-7), far inside the reference's own
    ``POST_RESCALE_RTOL`` = 2e-3;
  * the port's losses after a restore: equal to its own uninterrupted run
    bit for bit (one device, one program);
  * restart-budget exhaustion and the loss of every host: the reference's
    exceptions and messages;
  * ``run`` with a checkpoint directory: a resumed run equals an
    uninterrupted one bit for bit, and a JAX-written checkpoint resumes in
    the port with the JAX run's losses;
  * the launcher's ``--ckpt``, ``--chaos`` and ``--procs`` on the CPU,
    each held against the JAX launcher's run with the same flags.
"""
import shutil

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.ft import RescaleError as JRescaleError
from repro.launch import train as jlaunch
from repro.models import lm as jlm
from repro.parallel.sharding import init_params as jax_init
from repro.testing.x64 import x64_mode
from repro_torch.ft import RescaleError
from repro_torch.launch import train as launch
from repro_torch.params import params_from_jax
from repro_torch.testing import check_chaos
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

LOSS_RTOL = 1e-5
#: check_chaos's geometry: 2 hosts of 4 devices, model axis 2, batch 8 x 32
COMMON = dict(steps=12, seed=0, n_hosts=2, model_axis=2, global_batch=8,
              seq_len=32, ckpt_every=4, timeout_s=3.5, base_step_s=1.0,
              verbose=False)
RUNS = {"ref": "", "chaos": check_chaos.CHAOS_SPEC}
SAME = ("restarts", "n_restarts", "timeline", "fingerprints", "steps_executed",
        "virtual_seconds", "final_mesh_shape", "chaos_spec")


def _jax_params(seed=0):
    jp = jax_init(jlm.model_defs(jax_smoke_config("llama3-8b")), jax.random.key(seed))
    return params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each of check_chaos's two schedules through the reference's
    ``run_chaos`` (8 fake devices) and the port's (the JAX weights)."""
    out, params = {}, _jax_params()
    for name, spec in RUNS.items():
        d = tmp_path_factory.mktemp(name)
        with x64_mode(False):
            want = jlaunch.run_chaos(chaos_spec=spec, ckpt_dir=str(d / "jax"), **COMMON)
        got = launch.run_chaos(chaos_spec=spec, ckpt_dir=str(d / "port"),
                               device="cpu", params=params, **COMMON)
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_run_chaos_records_equal_jax(runs, name):
    got, want = runs[name]
    for k in SAME:
        assert got[k] == want[k], k
    assert sorted(got["losses_by_step"]) == list(range(COMMON["steps"]))


@pytest.mark.parametrize("name", list(RUNS))
def test_run_chaos_losses_match_jax(runs, name):
    got, want = runs[name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)


def test_check_chaos_passes_on_the_cpu():
    """``testing.check_chaos`` (the module phase 11 of chip_smoke.py runs
    on the card): its three assertions, every loss bit-equal."""
    out = check_chaos.main(device="cpu", params=_jax_params())
    assert out["chaos"]["restarts"][0]["restore_step"] == 4


def test_post_restore_losses_equal_the_uninterrupted_run(runs):
    """One device runs the same program before and after the restart, and
    the restored state is the saved bits: every loss equals the
    uninterrupted run's, bit for bit."""
    (chaos, _), (ref, _) = runs["chaos"], runs["ref"]
    assert chaos["steps_executed"] > COMMON["steps"]
    assert chaos["losses"] == ref["losses"]


@pytest.mark.parametrize("spec, kw, exc, jexc", [
    ("kill@2:h0", dict(max_restarts=0), RuntimeError, RuntimeError),
    ("kill@2:h0,kill@3:h1", {}, RescaleError, JRescaleError),
], ids=["budget-exhausted", "every-host-killed"])
def test_run_chaos_raises_as_jax(tmp_path, spec, kw, exc, jexc):
    common = dict(COMMON, steps=8, **kw)
    with x64_mode(False), pytest.raises(jexc) as want:
        jlaunch.run_chaos(chaos_spec=spec, ckpt_dir=str(tmp_path / "jax"), **common)
    with pytest.raises(exc) as got:
        launch.run_chaos(chaos_spec=spec, ckpt_dir=str(tmp_path / "port"),
                         device="cpu", **common)
    assert str(got.value) == str(want.value)


def test_run_chaos_refuses_bad_geometry():
    with pytest.raises(ValueError, match="not divisible"):
        launch.run_chaos(n_hosts=3, device="cpu")
    with pytest.raises(ValueError, match="model axis"):
        launch.run_chaos(n_hosts=8, model_axis=2, device="cpu")


def _leaf_bytes(d):
    return {f.name: f.read_bytes() for f in sorted(d.glob("leaf_*.npy"))}


def test_run_resumes_bit_exactly(tmp_path):
    """``run`` with checkpoints every 2 steps: a run resumed from the
    step-2 checkpoint alone gives steps 2-5's losses bit for bit and writes
    steps 4 and 6 with the same bytes."""
    kw = dict(steps=6, global_batch=4, seq_len=32, ckpt_every=2, device="cpu",
              log_every=100)
    whole = launch.run("llama3-8b", ckpt_dir=str(tmp_path / "whole"), **kw)
    shutil.copytree(tmp_path / "whole" / "step_00000002",
                    tmp_path / "resumed" / "step_00000002")
    resumed = launch.run("llama3-8b", ckpt_dir=str(tmp_path / "resumed"), **kw)
    assert (whole["start_step"], resumed["start_step"]) == (0, 2)
    assert resumed["losses"] == whole["losses"][2:]
    for step in ("step_00000004", "step_00000006"):
        assert _leaf_bytes(tmp_path / "resumed" / step) == \
            _leaf_bytes(tmp_path / "whole" / step)
    again = launch.run("llama3-8b", ckpt_dir=str(tmp_path / "whole"), **kw)
    assert (again["start_step"], again["losses"]) == (6, [])


def _flag_ckpt(tmp_path):
    """``--ckpt``: the JAX launcher's run writes its step-25 checkpoint; the
    port's launcher and the JAX one each resume from it to step 28."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    with x64_mode(False):
        jlaunch.run("llama3-8b", steps=26, ckpt_dir=str(jax_dir), log_every=100)
    shutil.copytree(jax_dir, port_dir)
    got = launch.main(["--device", "cpu", "--steps", "28", "--ckpt", str(port_dir)])
    with x64_mode(False):
        want = jlaunch.run("llama3-8b", steps=28, ckpt_dir=str(jax_dir), log_every=100)
    assert got["start_step"] == want["start_step"] == 25
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)


def _flag_chaos(tmp_path, runs):
    """``--chaos`` with check_chaos's schedule: the reference ``run_chaos``
    result the ``runs`` fixture holds (the same arguments as the JAX
    launcher passes).  The port's launcher draws its own weights, so its
    losses are not the reference's: the records are."""
    got = launch.main(["--device", "cpu", "--chaos", "--steps", "12", "--seq", "32",
                       "--ckpt-every", "4", "--chaos-spec", check_chaos.CHAOS_SPEC,
                       "--ckpt", str(tmp_path)])
    want = runs["chaos"][1]
    for k in SAME:
        assert got[k] == want[k], k


def _flag_procs(tmp_path):
    """``--chaos --procs``: a standby SIGKILLed at step 2 of 6, against the
    reference's supervisor with the same arguments (its workers on 8 fake
    devices); records equal but for the real latencies."""
    from repro.ft.cluster import ClusterSupervisor as JClusterSupervisor
    from repro_torch.testing.check_chaos_procs import _strip_timing

    args = dict(steps=6, hosts=2, ckpt_every=2, timeout=3.5, spec="kill@2:h1")
    got = launch.main(["--device", "cpu", "--chaos", "--procs", "--seq", "32",
                       "--steps", str(args["steps"]), "--hosts", str(args["hosts"]),
                       "--ckpt-every", str(args["ckpt_every"]),
                       "--timeout", str(args["timeout"]),
                       "--chaos-spec", args["spec"], "--ckpt", str(tmp_path / "port")])
    want = JClusterSupervisor(
        "llama3-8b", steps=args["steps"], n_hosts=args["hosts"], n_devices=8,
        model_axis=2, global_batch=8, seq_len=32, lr=3e-3,
        ckpt_dir=str(tmp_path / "jax"), ckpt_every=args["ckpt_every"],
        chaos_spec=args["spec"], timeout_s=args["timeout"], max_restarts=3,
        n_microbatches=1, verbose=False).run()
    g, w = _strip_timing(got), _strip_timing(want)
    for k in g:
        if k != "losses":
            assert g[k] == w[k], k
    assert got["n_restarts"] == 1 and got["restarts"][0]["lost_hosts"] == [1]


@pytest.mark.parametrize("flag", ["--ckpt", "--chaos", "--procs"])
def test_launcher_takes_the_reference_flags(flag, tmp_path, runs):
    {"--ckpt": lambda: _flag_ckpt(tmp_path),
     "--chaos": lambda: _flag_chaos(tmp_path, runs),
     "--procs": lambda: _flag_procs(tmp_path)}[flag]()


def test_launcher_procs_needs_chaos(capsys):
    with pytest.raises(SystemExit):
        launch.main(["--device", "cpu", "--procs"])
    assert "--procs requires --chaos" in capsys.readouterr().err
