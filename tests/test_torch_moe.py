"""The MoE family through the port against the JAX package (CPU, f32 smoke
configs, the JAX initialiser's weights carried over by ``params_from_jax``):
the MoE sublayer (routing, capacity, drops), prefill and decode, the dense
and paged engines' greedy streams, the launchers, the launch counts of a
serving run and of a train step, training (the loss and every gradient
leaf against ``jax.grad``, at the smoke capacity and at one that drops
pairs; three train steps with one and two microbatches), and what the
port still refuses (a paged windowed model; the cross-attention families
in the serving engines, which take no context).

mixtral-8x7b-smoke is the one registered arch with a sliding window (16
at smoke size); qwen3-moe-235b-a22b-smoke carries the paged path (full
attention)."""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules, init_params as jax_init
from repro.serve import PagedServeConfig as JPagedServeConfig
from repro.serve import PagedServingEngine as JPagedServingEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention, matmul, ops, rmsnorm
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.params import params_from_jax
from repro_torch.serve import (PagedServeConfig, PagedServingEngine, Request,
                               ServeConfig, ServingEngine)
from repro_torch.testing import train_checks as tc
from repro_torch.train import trainer
import torch_jax_smoke as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

RULES = default_rules(None)
# f32 on both sides; only the summation order of the products differs
TOL = dict(rtol=1e-5, atol=1e-5)
MOE = ["mixtral-8x7b", "qwen3-moe-235b-a22b"]
#: 48 rows, 2 of 4 experts each: C = ceil(48 * 2 / 4 * 0.5) = 12 of the 24
#: pairs an expert gets on average, so capacity binds
LOW_CAPACITY = 0.5
SCFG = dict(max_batch=4, max_seq=64, block_tokens=8, n_blocks=32)


def _setup(name, **over):
    jcfg = dataclasses.replace(jax_smoke_config(name), **over)
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_drops(jsp, x, jcfg) -> set:
    """The (row, expert) pairs the JAX layer drops: its routing lines
    (``moe_layer``) and the capacity slots of ``_dispatch_ffn``, in numpy."""
    xn = JL.rmsnorm(jnp.asarray(x), jsp["norm"], jcfg.norm_eps)
    _, idx = jax.lax.top_k(xn.astype(jnp.float32) @ jsp["router"],
                           jcfg.experts_per_token)
    idx = np.asarray(idx).reshape(-1, jcfg.experts_per_token)
    N, E = idx.shape[0], jcfg.n_experts
    C = max(1, int(np.ceil(N * jcfg.experts_per_token / E * jcfg.capacity_factor)))
    drops = set()
    for j in range(E):
        chosen = (idx == j).any(-1)
        pos = np.cumsum(chosen) - 1
        drops |= {(n, j) for n in np.flatnonzero(chosen & (pos >= C))}
    return drops


def _port_drops(r: L.Routing) -> set:
    chosen = torch.zeros_like(r.slots).scatter_(0, r.idx.T, 1) > 0
    return {(n, j) for j, n in
            torch.nonzero(chosen & (r.slots == r.capacity)).tolist()}


@pytest.mark.parametrize("factor", [None, LOW_CAPACITY], ids=["smoke", "binding"])
@pytest.mark.parametrize("name", MOE)
def test_moe_layer_matches_jax(name, factor):
    """At the smoke capacity (8.0: nothing drops) and at one where capacity
    binds: the same output within 1e-5, and the same dropped pairs, which
    are none at 8.0 and some at the low factor."""
    over = {} if factor is None else {"capacity_factor": factor}
    jcfg, cfg, jp, tp = _setup(name, **over)
    jsp = jax.tree.map(lambda t: t[0], jp["period"]["l0"]["s1_moe"])
    sp = jax.tree.map(lambda t: t[0], tp["period"]["l0"]["s1_moe"])
    x = np.random.default_rng(0).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    _close(L.moe_layer(sp, torch.from_numpy(x), cfg),
           JL.moe_layer(jsp, jnp.asarray(x), jcfg, RULES))
    xn = L.rmsnorm(torch.from_numpy(x), sp["norm"], cfg.norm_eps)
    route = L.moe_route(sp, xn, cfg)
    drops = _port_drops(route)
    assert drops == _jax_drops(jsp, x, jcfg)
    assert bool(drops) == (factor is not None)
    assert route.capacity == L.moe_capacity(cfg, 48) == (12 if factor else 192)


def test_expert_slots_count_earlier_rows_and_drop_past_capacity():
    idx = torch.tensor([[0, 1], [1, 2], [1, 0], [1, 3]])
    slots = L.expert_slots(idx, 4, C=2)
    # expert 1 is chosen by rows 0-3: slots 0, 1, then two drops (C = 2)
    assert slots.T.tolist() == [[0, 0, 2, 2], [2, 1, 0, 2],
                                [1, 2, 2, 2], [2, 2, 2, 0]]


@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_logits_match_jax(name):
    """A 20-token prompt (past mixtral's 16-token window: the ring rolls)
    and 4 decode steps, the last wrapping the ring."""
    jcfg, cfg, jp, tp = _setup(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 20)).astype(np.int32)
    jc, jl = jlm.prefill(jp, jnp.asarray(toks), jcfg, RULES, 32)
    tc, tl = lm.prefill(tp, torch.from_numpy(toks).long(), cfg, 32)
    _close(tl, jl)
    for step in range(4):
        nxt = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jc, jnp.int32(20 + step),
                                 jcfg, RULES)
        tl, tc = lm.decode_step(tp, torch.from_numpy(nxt).long(), tc, 20 + step, cfg)
        _close(tl, jl)


def test_decode_matches_forward_mixtral():
    """``tests/test_arch_smoke.py::test_decode_matches_forward`` on the port:
    prefill(t[:8]) and 8 decode steps give the full prefill's last logits."""
    cfg = get_smoke_config("mixtral-8x7b")
    _, _, _, tp = _setup("mixtral-8x7b")
    B, S, k = 2, 16, 8
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S))).long()
    _, full_last = lm.prefill(tp, tokens, cfg, S)
    cache, lg = lm.prefill(tp, tokens[:, :k], cfg, S)
    for i in range(k, S):
        lg, cache = lm.decode_step(tp, tokens[:, i:i + 1], cache, i, cfg)
    np.testing.assert_allclose(lg[:, 0].numpy(), full_last[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)


def _prompts(vocab):
    """A paged prompt set: duplicates beside their originals."""
    rng = np.random.default_rng(0)
    base = [rng.integers(1, vocab, int(rng.integers(5, 20))).astype(np.int32)
            for _ in range(4)]
    return [base[0], base[0].copy(), base[1], base[1].copy(), base[2], base[3]]


def _drive(engine, prompts, req=Request, new=8):
    reqs = [req(rid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.rid: list(r.out) for r in reqs}


@pytest.mark.parametrize("name", MOE)
def test_dense_engine_streams_match_jax(name):
    """6 requests through 4 slots (dead slots decode token 0 and take
    capacity, as in JAX), max_seq 64."""
    jcfg, cfg, jp, tp = _setup(name)
    prompts = _prompts(cfg.vocab_size)
    jeng = JServingEngine(jcfg, jp, RULES, JServeConfig(max_batch=4, max_seq=64))
    eng = ServingEngine(lm.Model(cfg, tp), ServeConfig(max_batch=4, max_seq=64),
                        device="cpu")
    want = _drive(jeng, prompts, JRequest, new=12)
    assert _drive(eng, prompts, new=12) == want and len(want) == 6


@pytest.mark.parametrize("chunk", [0, 16])
def test_paged_engine_streams_and_counters_match_jax(chunk):
    """qwen3-moe through the paged engine, whole-prompt and in 16-token
    chunks (whose padding rows take capacity, as in JAX)."""
    jcfg, cfg, jp, tp = _setup("qwen3-moe-235b-a22b")
    prompts = _prompts(cfg.vocab_size)
    jeng = JPagedServingEngine(jcfg, jp, RULES, JPagedServeConfig(**SCFG, chunk=chunk))
    eng = PagedServingEngine(lm.Model(cfg, tp), PagedServeConfig(**SCFG, chunk=chunk),
                             device="cpu")
    want = _drive(jeng, prompts, JRequest)
    assert _drive(eng, prompts) == want
    assert eng.alloc.shared_hits == jeng.alloc.shared_hits
    assert eng.cow_copies == jeng.cow_copies
    assert eng.prefill_chunks == jeng.prefill_chunks
    assert eng.decode_steps == jeng.decode_steps
    eng.shutdown()
    for leaf in jax.tree.leaves(eng.pool):
        assert not leaf[:, 0].any(), "zero block written"


def test_paged_engine_refuses_mixtral_as_jax_does():
    jcfg, cfg, jp, tp = _setup("mixtral-8x7b")
    with pytest.raises(ValueError, match="full attention") as jerr:
        JPagedServingEngine(jcfg, jp, RULES, JPagedServeConfig(**SCFG))
    with pytest.raises(ValueError, match="full attention") as err:
        PagedServingEngine(lm.Model(cfg, tp), PagedServeConfig(**SCFG), device="cpu")
    assert str(err.value) == str(jerr.value)


def test_serve_launcher_serves_mixtral_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mixtral-8x7b",
         "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "4"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "[serve] 3 requests" in proc.stdout and "[dense, cpu]" in proc.stdout


def test_serve_launcher_refuses_mixtral_paged():
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="full attention"):
        serve.main(["--arch", "mixtral-8x7b", "--device", "cpu", "--paged"])


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2", "llama-3.2-vision-11b"])
def test_cross_attention_families_are_refused(name):
    """The refusal that stays: the encdec and vlm families train and serve
    through ``lm.prefill(..., ctx_embeds)`` and ``lm.decode_step``, but no
    engine takes a context (the reference's engine prefills without one),
    so the dense and paged engines and the serve launcher refuse them, the
    launcher before it draws a weight."""
    from repro_torch.launch import serve
    cfg = get_smoke_config(name)
    model = lm.Model(cfg, tc.smoke_params(name))
    with pytest.raises(ValueError, match="take no context") as err:
        ServingEngine(model, ServeConfig(max_batch=2, max_seq=32), device="cpu")
    assert name in str(err.value) and "lm.prefill(..., ctx_embeds)" in str(err.value)
    with pytest.raises(ValueError, match="take no context"):
        PagedServingEngine(model, PagedServeConfig(**SCFG), device="cpu")
    drawn = []
    orig = serve.init_params
    serve.init_params = lambda *a, **kw: drawn.append(1) or orig(*a, **kw)
    try:
        for argv in ([], ["--paged"], ["--pods", "2"]):
            with pytest.raises(ValueError, match="take no context"):
                serve.main(["--arch", name, "--device", "cpu", "--requests", "1"]
                           + argv)
    finally:
        serve.init_params = orig
    assert not drawn


def _counting(monkeypatch) -> dict:
    """Calls of the functions that launch the kernels on the card: on the
    CPU they stand where the kernels launch."""
    counts = dict.fromkeys(ops.LAUNCHES, 0)
    for cls, key in ((rmsnorm.RMSNorm, "rmsnorm"), (matmul.Matmul, "matmul"),
                     (flash_attention.FlashAttention, "flash_attention")):
        orig = cls.forward

        def wrapped(ctx, *a, _orig=orig, _key=key):
            counts[_key] += 1
            return _orig(ctx, *a)
        monkeypatch.setattr(cls, "forward", staticmethod(wrapped))
    paged = ops.paged_attention

    def paged_counted(*a):
        counts["paged_attention"] += 1
        return paged(*a)
    monkeypatch.setattr(ops, "paged_attention", paged_counted)
    return counts


@pytest.mark.parametrize("name", ["llama3-8b", *MOE])
def test_serve_launches_is_the_count_of_a_serving_run(monkeypatch, name):
    """``trainer.serve_launches`` against the calls of a dense engine's run
    and, for the full-attention archs, of a paged chunked one."""
    cfg = get_smoke_config(name)
    _, _, _, tp = _setup(name)
    model = lm.Model(cfg, tp)
    prompts = _prompts(cfg.vocab_size)
    counts = _counting(monkeypatch)
    eng = ServingEngine(model, ServeConfig(max_batch=4, max_seq=64), device="cpu")
    _drive(eng, prompts)
    tm = eng.timing
    assert counts == trainer.serve_launches(cfg, tm["prefills"], tm["decode_steps"])
    if cfg.window:
        return
    counts.update(dict.fromkeys(counts, 0))
    eng = PagedServingEngine(model, PagedServeConfig(**SCFG, chunk=16), device="cpu")
    _drive(eng, prompts)
    tm = eng.timing
    assert tm["chunks"] > 0
    assert counts == trainer.serve_launches(cfg, tm["prefills"], tm["decode_steps"],
                                            chunks=tm["chunks"], paged=True)


def test_serve_launches_at_mixtrals_cut():
    """24 layers of attention and an 8-expert MoE: 4 + 24 projections and 2
    norms a layer, the final norm, a flash attention a layer a prefill."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=24)
    got = trainer.serve_launches(cfg, prefills=2, decode_steps=3)
    assert {k: v for k, v in got.items() if v} == {
        "rmsnorm": 49 * 5, "matmul": 28 * 24 * 5, "flash_attention": 48}


@pytest.mark.parametrize("name", MOE)
def test_moe_term_scale_bounds_the_layers_sum(name):
    """``kernel_checks.moe_term_scale`` (the card check's scale) sums the
    magnitudes of the layer's addends: x and each expert's gated output."""
    from repro_torch.testing import kernel_checks as kc
    _, cfg, _, tp = _setup(name, capacity_factor=LOW_CAPACITY)
    sp = jax.tree.map(lambda t: t[0], tp["period"]["l0"]["s1_moe"])
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32))
    scale = kc.moe_term_scale(sp, x, cfg)
    y = (L.moe_layer(sp, x, cfg) - x).reshape(scale.shape)
    xa = x.reshape(scale.shape).abs()
    assert bool((y.abs() <= scale - xa + 1e-5).all())
    assert float((scale - xa).max()) > 0.5           # the experts' outputs count


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
#
# Tolerances as ``tests/test_torch_train.py`` states them: the loss within
# rtol 1e-5, each gradient leaf within ``1e-4 |want| + 2e-5 max|want|``
# (``torch_jax_smoke.assert_grads_match_jax``), the train steps within
# ``testing/train_checks.py``'s limits.
#: (arch, config overrides) of the gradient cases: the smoke capacity
#: factor of 8.0 (nothing drops) and the binding one
GRAD_CASES = {"mixtral": ("mixtral-8x7b", {}),
              "qwen3": ("qwen3-moe-235b-a22b", {}),
              "qwen3-binding": ("qwen3-moe-235b-a22b",
                                {"capacity_factor": LOW_CAPACITY}),
              "mixtral-remat": ("mixtral-8x7b", {"remat": True})}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_forward_train_loss_and_every_grad_leaf_match_jax(case):
    """Autograd through the router, the capacity dispatch (the scatter into
    each expert's C + 1 rows, the gather back) and the expert products; at
    the binding factor pairs drop, and a dropped pair takes no gradient."""
    name, over = GRAD_CASES[case]
    jcfg, cfg, jp, tp = _setup(name, **over)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    if "capacity_factor" in over:
        x = tp["embed"][torch.from_numpy(toks).long()]
        sp = jax.tree.map(lambda t: t[0], tp["period"]["l0"]["s1_moe"])
        assert _port_drops(L.moe_route(sp, L.rmsnorm(x, sp["norm"], cfg.norm_eps), cfg))
    J.assert_grads_match_jax(jcfg, cfg, jp, tp, toks)


def test_capacity_counts_a_microbatchs_rows():
    """At the binding factor, half the batch routes with half the rows'
    capacity: C = ceil(N k / E f) of the microbatch's N."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"),
                              capacity_factor=LOW_CAPACITY)
    assert L.moe_capacity(cfg, 4 * 32) == 32
    assert L.moe_capacity(cfg, 2 * 32) == 16


@pytest.mark.parametrize("name", MOE)
def test_smoke_weights_files_are_the_jax_init(name):
    """The weights phase 4b of chip_smoke.py trains the MoE smoke models
    from are ``init_params`` of the JAX smoke model at key 0, bit for bit."""
    J.assert_weights_file_is_the_jax_init(name)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("name", MOE)
def test_step_launches_is_the_count_of_a_moe_train_step(monkeypatch, name,
                                                        n_microbatches, remat):
    """3E expert products a MoE sublayer, each with its dX and dW."""
    cfg = dataclasses.replace(get_smoke_config(name), remat=remat)
    assert J.count_train_step(monkeypatch, cfg, n_microbatches) == \
        trainer.step_launches(cfg, n_microbatches)


def test_card_checks_take_mixtrals_train_shapes():
    """C = 1,280 buffer rows an expert at the train step's 4 x 1024 tokens,
    its window over them, and a C that is not a multiple of 8."""
    from repro_torch.configs import get_config
    from repro_torch.testing import kernel_checks as kc
    cfg = get_config("mixtral-8x7b")
    assert kc.MOE_TRAIN_C == (L.moe_capacity(cfg, 4 * 1024), L.moe_capacity(cfg, 4105))
    assert kc.MOE_TRAIN_C[1] % 8
    assert kc.MIXTRAL_TRAIN_FLASH == (4, 1024, cfg.window)


def test_step_launches_at_mixtrals_training_cut():
    """mixtral-8x7b at 2 of its 32 layers under remat: 2 attention and 2
    MoE sublayers of 8 experts, 4 + 24 products and 2 norms a layer."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=2)
    assert trainer.step_launches(cfg) == {
        "rmsnorm": 9, "matmul": 112, "flash_attention": 4, "rmsnorm_bwd": 5,
        "matmul_bwd": 112, "flash_attention_bwd": 2}


def test_train_launcher_trains_mixtral_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mixtral-8x7b",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--microbatches", "2"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[train]")]
    assert "step     0" in lines[0] and "[cpu]" in lines[0]
    assert lines[-1].startswith("[train] done: first loss")
