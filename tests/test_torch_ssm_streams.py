"""The Mamba2 family's greedy streams through the port's dense engine
against the JAX engine's (CPU, f32 smoke configs, the JAX initialiser's
weights).  Apart from ``test_torch_ssm.py`` (the SSD, the sublayer, decode,
the paged refusal) so that each file fits a worker's share of the
suite."""
import numpy as np
import pytest

from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServingEngine
from test_torch_ssm import RULES, SSM, _drive, _setup
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


@pytest.mark.parametrize("name", SSM)
def test_dense_engine_streams_match_jax(name):
    """6 requests of 5-19 tokens through 4 slots, max_seq 64: a slot's Mamba
    state is the prefill's at admit, and a dead slot's runs on, as in JAX."""
    jcfg, cfg, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(5, 20))).astype(np.int32)
               for _ in range(6)]
    jeng = JServingEngine(jcfg, jp, RULES, JServeConfig(max_batch=4, max_seq=64))
    eng = ServingEngine(lm.Model(cfg, tp), ServeConfig(max_batch=4, max_seq=64),
                        device="cpu")
    want = _drive(jeng, prompts, JRequest)
    assert _drive(eng, prompts) == want and len(want) == 6
