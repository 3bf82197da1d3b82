"""The port's multi-process chaos cluster (``repro_torch.ft.cluster``)
against the JAX package's: the wire framing, the worker spec, the
supervisor's refusals and its ``ckpt_crash`` mapping, the real-SIGKILL
heartbeat drill (twins of ``tests/test_chaos.py``'s cluster cases, the
framing and mapping also fed to the reference), and
``testing.check_chaos_procs`` on the CPU: three supervised runs of worker
processes, real SIGKILLs, every loss bit-equal to the uninterrupted run's.
Every subprocess runs under its own timeout."""
import json
import subprocess
import sys

import pytest

from repro.ft import cluster as jcluster
from repro_torch.ft import cluster
from repro_torch.ft.cluster import (ROLE_PRIMARY, ClusterSupervisor, Framer,
                                    WorkerSpec, drill, encode_msg)
from repro_torch.testing.subproc import SRC, pinned_env
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

MSGS = [{"kind": "beat", "host": h, "n": 10 * h} for h in range(3)] + [
    {"kind": "step", "step": 4, "loss": 6.5, "fp": "ab" * 8},
    {"kind": "epoch", "host": 0, "restore_step": 4, "mesh_shape": [3, 2]}]


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_framer_reassembles_arbitrary_chunking(chunk):
    wire = b"".join(encode_msg(m) for m in MSGS)
    assert wire == b"".join(jcluster.encode_msg(m) for m in MSGS)
    f, got = Framer(), []
    for i in range(0, len(wire), chunk):
        got.extend(f.feed(wire[i:i + chunk]))
    assert got == MSGS


def test_worker_spec_roundtrip_and_reference_fields():
    spec = WorkerSpec(host=1, n_hosts=4, port=5555, role=ROLE_PRIMARY,
                      devices_per_host=2, model_axis=2, steps=10, seed=3,
                      ckpt_dir="ckpt", failed=[2, 3], fence_steps=[4],
                      ckpt_hold_step=8, device="cpu")
    assert WorkerSpec.from_json(spec.to_json()) == spec
    fields = json.loads(spec.to_json())
    assert fields.pop("device") == "cpu"
    assert fields == json.loads(jcluster.WorkerSpec(**fields).to_json())


def test_supervisor_rejects_bad_geometry_and_straggles(tmp_path):
    with pytest.raises(ValueError, match="not divisible"):
        ClusterSupervisor(n_hosts=3, n_devices=8, device="cpu")
    with pytest.raises(ValueError, match="model axis"):
        ClusterSupervisor(n_hosts=8, n_devices=8, model_axis=2, device="cpu")
    with pytest.raises(ValueError, match="virtual-clock-only"):
        ClusterSupervisor(chaos_spec="straggle@1:h1:x2.5:d2", device="cpu",
                          ckpt_dir=str(tmp_path), logdir=str(tmp_path))


def test_supervisor_refuses_the_card_where_there_is_none(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterSupervisor(ckpt_dir=str(tmp_path), logdir=str(tmp_path))


@pytest.mark.parametrize("spec, every", [("ckpt_crash@5", 4), ("ckpt_crash@8", 4),
                                         ("ckpt_crash@0,ckpt_crash@7", 2)])
def test_ckpt_crash_maps_to_the_next_save_as_jax(tmp_path, spec, every):
    """A ``ckpt_crash@S`` tears the first save strictly after step S and is
    consumed once delivered, as the reference's supervisor maps it."""
    kw = dict(chaos_spec=spec, ckpt_every=every, ckpt_dir=str(tmp_path),
              logdir=str(tmp_path))
    got, want = ClusterSupervisor(device="cpu", **kw), jcluster.ClusterSupervisor(**kw)
    for sup in (got, want):
        sup._pending = list(sup.schedule.events)
    while True:
        assert got._next_hold_step() == want._next_hold_step()
        if got._next_hold_step() is None:
            break
        got._consume_ckpt_crash()
        want._consume_ckpt_crash()


def test_drill_detects_a_real_sigkill_via_the_socket():
    """Two standby workers (no torch in them), one SIGKILLed: the monitor
    notices by missed heartbeats, never before the deadline."""
    out = drill(n_workers=2, kill_host=1, timeout_s=0.6, beat_interval_s=0.05)
    assert out["dead"] == [1]
    assert 0.5 < out["detect_s"] < 60.0, out


def test_standby_worker_imports_no_torch():
    code = ("import sys, repro_torch.ft.cluster\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=pinned_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert pinned_env()["PYTHONPATH"].split(":")[0] == SRC
    assert cluster.spawn_worker.__module__ == "repro_torch.ft.cluster"


def test_check_chaos_procs_on_the_cpu():
    """``testing.check_chaos_procs`` with the primary on the CPU: the
    reference run, the chaos run (two standbys and then the primary
    SIGKILLed, the last mid-save) and the seeded rerun, with every
    assertion of the module; the whole under one timeout."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.check_chaos_procs",
         "--device", "cpu"], capture_output=True, text=True, env=pinned_env(),
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "check_chaos_procs OK on cpu" in proc.stdout
