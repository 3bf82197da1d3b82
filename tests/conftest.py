"""Shared test bootstrap — the ONE place the test env is mutated.

Fake-device setup: multi-device behaviour must be identical under bare
``pytest`` and under ``scripts/ci.sh`` (which exports the same env), so the
8-CPU-device flags are set *here*, idempotently — an inherited device-count
flag or platform choice is respected, never clobbered.  Lint rule L2's env
sub-rule (``repro.analysis``) rejects any *test module* touching
``XLA_FLAGS`` / ``JAX_PLATFORMS`` at import time: by the time a module
imports, jax may already be initialised and the flip silently no-ops on
part of the suite — this file runs before collection, so here it is safe.

The offline CI image has no ``hypothesis``; install the deterministic compat
shim before the property-test modules are collected.  With the real package
available the shim is a no-op.
"""
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        + os.environ.get("XLA_FLAGS", "")).strip()

_SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro.testing import hypothesis_compat

hypothesis_compat.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where there is none")
