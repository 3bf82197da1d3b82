"""Write the JAX initialiser's llama3-8b smoke weights (seed 0) as numpy.

    PYTHONPATH=src python scripts/make_torch_smoke_weights.py

``chip_smoke.py`` (phase 4b) trains the port from these weights on the card
and on the CPU without importing JAX; ``tests/test_torch_train.py`` checks
that the file still equals ``repro.parallel.sharding.init_params`` of the
smoke model at ``jax.random.key(0)``.  Keys are the tree's dotted paths.
"""
from __future__ import annotations

import pathlib

import jax
import numpy as np

from repro.configs import get_smoke_config
from repro.models import lm
from repro.parallel.sharding import init_params

OUT = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "testing" / "llama3-8b-smoke-jax-seed0.npz")


def jax_smoke_weights() -> dict:
    """{dotted path: f32 array} of the smoke model's JAX init at key 0."""
    params = init_params(lm.model_defs(get_smoke_config("llama3-8b")),
                         jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {".".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in flat}


if __name__ == "__main__":
    np.savez_compressed(OUT, **jax_smoke_weights())
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
