"""The port stands alone: it imports neither jax, nor the JAX package, nor
triton (not even inside a function); its entry points refuse to drift onto the CPU; and
the JAX weight carry-over is exact."""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.params import params_from_jax
from repro_torch.serve import ServeConfig, ServingEngine

ROOT = pathlib.Path(repro_torch.__file__).resolve().parent
REPO = ROOT.parents[1]


def _modules():
    mods = []
    for p in sorted(ROOT.rglob("*.py")):
        parts = ("repro_torch",) + p.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_sweep_finds_the_package():
    mods = _modules()
    assert {"repro_torch.kernels.ops", "repro_torch.serve.engine",
            "repro_torch.launch.serve"} <= set(mods)


def test_importing_every_module_pulls_in_no_jax_repro_or_triton():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", [*sorted(ROOT.rglob("*.py")),
                                  REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            # no triton either: every kernel of the port is CUDA C++
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro", "triton"), \
                f"{path}:{node.lineno} imports {name}"


def test_chip_smoke_last_line_names_the_card():
    """The last line's ``device`` object reads the card's name and count
    where it is printed, so no variable of the script can stand in for
    them."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    devices = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
               and any(isinstance(k, ast.Constant) and k.value == "platform"
                       for k in n.keys)]
    assert len(devices) == 1
    fields = {k.value: ast.unparse(v) for k, v in zip(devices[0].keys,
                                                      devices[0].values)}
    assert fields == {"platform": "'gpu'",
                      "kind": "torch.cuda.get_device_name(0)",
                      "count": "torch.cuda.device_count()"}


@pytest.mark.parametrize("args", [[], ["--only", "matmul-bwd"], ["--only", "phi3"],
                                  ["--only", "moe"], ["--only", "moe-train"],
                                  ["--only", "ssm"], ["--only", "xattn"],
                                  ["--only", "state"], ["--only", "machine"],
                                  ["--only", "tooling"]],
                         ids=["whole", "matmul-bwd", "phi3", "moe", "moe-train", "ssm",
                              "xattn", "state", "machine", "tooling"])
def test_chip_smoke_exits_without_a_card(args):
    """Without a CUDA card the script exits 2 before any phase, in either
    mode, and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *args],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 2, out.stderr
    assert out.stdout == "" and "runs on a CUDA card" in out.stderr


def test_engine_refuses_to_run_on_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device is usable")
    cfg = get_smoke_config("llama3-8b")
    model = lm.Model(cfg, {"embed": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, ServeConfig())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_is_exact(dtype):
    x = jax.random.normal(jax.random.key(0), (3, 5, 7), jnp.float32).astype(dtype)
    tree = {"period": {"l0": {"w": np.asarray(x)}}, "g": np.asarray(x[0])}
    out = params_from_jax(tree)
    w = out["period"]["l0"]["w"]
    assert w.dtype == {jnp.float32: torch.float32,
                       jnp.bfloat16: torch.bfloat16}[dtype]
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    w.add_(1)                           # a writable copy, not a view of JAX's
    np.testing.assert_array_equal(out["g"].float().numpy(),
                                  np.asarray(x[0].astype(jnp.float32)))
