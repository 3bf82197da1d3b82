"""The twin of ``examples/train_lm.py`` (``repro_torch.examples.train_lm``)
on the CPU: its model configs are the reference example's, and a run of
``--small`` resumed once from its step-100 checkpoint continues the
uninterrupted run's losses bit for bit (nothing killed)."""
import dataclasses
import importlib.util
import pathlib
import shutil

import pytest

from repro_torch.examples import train_lm
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", REPO / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("small", [True, False])
def test_configs_are_the_reference_examples(small):
    """Every field both configs have is the reference's (the dtype by
    name), and so is the parameter count."""
    got, want = train_lm.lm100m(small), _reference_example().lm100m(small)
    assert got.n_params() == want.n_params()
    shared = {f.name for f in dataclasses.fields(got)} & \
        {f.name for f in dataclasses.fields(want)}
    assert len(shared) > 20
    for name in shared - {"dtype"}:
        assert getattr(got, name) == getattr(want, name), name
    assert str(got.dtype).removeprefix("torch.") == want.dtype.__name__


def test_small_run_resumes_bit_for_bit(tmp_path):
    """104 steps checkpointing at step 100, then the same command on a
    directory holding only that checkpoint: it resumes at 100 and gives
    steps 100-103's losses bit for bit."""
    argv = ["--small", "--steps", "104", "--device", "cpu"]
    whole = train_lm.main(argv + ["--ckpt", str(tmp_path / "whole")])
    assert len(whole["losses"]) == 104
    shutil.copytree(tmp_path / "whole" / "step_00000100",
                    tmp_path / "resumed" / "step_00000100")
    resumed = train_lm.main(argv + ["--ckpt", str(tmp_path / "resumed")])
    assert resumed["start_step"] == 100
    assert resumed["losses"] == whole["losses"][100:]
