"""The port's model and serving engine against the JAX package's, with the
JAX initialiser's weights carried over and the same prompts (CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules, init_params as jax_init
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.params import params_from_jax
from repro_torch.serve import Request, ServeConfig, ServingEngine
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

RULES = default_rules(None)
CONFIGS = {
    "llama3": ("llama3-8b", {}),
    "glm4": ("glm4-9b", {}),                       # another norm_eps, kv=2
    "llama3-swa16": ("llama3-8b", {"window": 16}),  # SWA ring buffer
    "llama3-kv4": ("llama3-8b", {"n_kv_heads": 4}),  # no GQA
}


def _setup(case, **over):
    name, base = CONFIGS[case]
    over = {**base, **over}
    jover = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
             for k, v in over.items()}
    jcfg = dataclasses.replace(jax_smoke_config(name), **jover)
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_prefill_and_teacher_forced_decode_logits():
    """f32 end to end: 1e-5, only summation orders differ."""
    jcfg, cfg, jp, tp = _setup("llama3")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc, jl = jlm.prefill(jp, jnp.asarray(toks), jcfg, RULES, 32)
    tc, tl = lm.prefill(tp, torch.from_numpy(toks).long(), cfg, 32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for step in range(4):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = 9 + step
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(pos),
                                 jcfg, RULES)
        tl, tc = lm.decode_step(tp, torch.from_numpy(nxt).long(), tc, pos, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc["l0"]["s0_attn"]["k"].numpy(),
                               np.asarray(jc["l0"]["s0_attn"]["k"]),
                               rtol=1e-5, atol=1e-5)


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(1, vocab, int(rng.integers(4, 24))).astype(np.int32)
            for _ in range(5)]


@pytest.mark.parametrize("case", list(CONFIGS))
def test_engine_streams_match_jax(case):
    """5 requests through 2 slots (slots recycle), max_seq 64: the greedy
    token streams are identical."""
    jcfg, cfg, jp, tp = _setup(case)
    jeng = JServingEngine(jcfg, jp, RULES, JServeConfig(max_batch=2, max_seq=64))
    eng = ServingEngine(lm.Model(cfg, tp), ServeConfig(max_batch=2, max_seq=64),
                        device="cpu")
    for rid, prompt in enumerate(_prompts(cfg.vocab_size)):
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new_tokens=12))
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=12))
    want = {r.rid: r.out for r in jeng.run()}
    got = {r.rid: r.out for r in eng.run()}
    assert got == want
    assert eng.peak_live == 2 and len(got) == 5


def test_engine_records_its_own_spans():
    """The engine times its prefills and decode steps itself, and stamps
    each request's submit and first-token times."""
    _, cfg, _, tp = _setup("llama3")
    eng = ServingEngine(lm.Model(cfg, tp), ServeConfig(max_batch=2, max_seq=64),
                        device="cpu")
    for rid, prompt in enumerate(_prompts(cfg.vocab_size)):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=4))
    done = eng.run()
    tm = eng.timing
    assert tm["prefills"] == 5 and tm["prefill_s"] > 0
    assert tm["decode_steps"] >= 3 * 5 / 2 and tm["decode_s"] > 0
    assert all(0 < r.t_submit <= r.t_first for r in done)


def test_bf16_prefill_logits():
    """bf16 storage: the two frameworks round activations to bf16 at
    different points inside each sublayer, so a few bf16 ulps of the logit
    scale (0.05 absolute on logits of order 1)."""
    jcfg, cfg, jp, tp = _setup("llama3", dtype=torch.bfloat16)
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (1, 11))
    _, jl = jlm.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, RULES, 16)
    _, tl = lm.prefill(tp, torch.from_numpy(toks), cfg, 16)
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)),
                               rtol=0, atol=5e-2)


def test_model_state_dict_keys_are_jax_paths():
    _, cfg, _, tp = _setup("llama3")
    keys = set(lm.Model(cfg, tp).state_dict())
    assert "period.l0.s0_attn.wq" in keys and "period.l0.s1_mlp.wg" in keys
    assert {"embed", "final_norm", "head"} <= keys


def test_launcher_serves_on_the_cpu_and_refuses_unported_modes(capsys):
    """Dense, paged, paged with chunked prefill, and two pods behind the
    router all serve on the CPU, with the same streams."""
    from repro_torch.launch import serve
    done = serve.run("llama3-8b", n_requests=3, max_new=4, max_batch=2,
                     device="cpu")
    assert len(done) == 3 and all(1 <= len(r.out) <= 4 for r in done)
    assert "[serve] 3 requests" in capsys.readouterr().out
    want = None
    for flags, mode in ((["--paged"], "[paged, cpu]"),
                        (["--paged", "--chunk", "16"], "[paged+chunked, cpu]"),
                        (["--pods", "2"], "[dense pods=2, cpu]")):
        done = serve.main(["--device", "cpu", "--requests", "4",
                           "--max-new", "4", *flags])
        assert mode in capsys.readouterr().out
        streams = {r.rid: r.out for r in done}
        assert len(streams) == 4 and streams == (want or streams)
        want = streams
