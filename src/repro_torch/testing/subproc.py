"""The environment of a subprocess of the port (the chaos cluster's workers,
the check modules the tests run).

The port's counterpart of ``repro.testing.subproc.pinned_env``: ``src`` on
``PYTHONPATH``, so ``python -m repro_torch...`` imports this checkout's
package whatever the parent inherited.  The port needs no fake-device flag:
its logical devices are ids (``ft.resilience``), and a worker that trains
takes the card it is given by name.
"""
from __future__ import annotations

import os
import pathlib

SRC = str(pathlib.Path(__file__).resolve().parents[2])


def pinned_env() -> dict[str, str]:
    """This process's environment with ``src`` first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    return env
