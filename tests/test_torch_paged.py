"""Paged-KV serving in the port against the JAX package's (CPU, f32 smoke
configs, the JAX initialiser's weights carried over): the paged layer, the
paged model steps, the engine's greedy streams and block accounting, the
allocator, the router, and the open-loop traffic generator."""
import dataclasses

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
from repro.serve import PrefixRouter as JPrefixRouter
from repro.serve import Request as JRequest
from repro.serve import traffic as jtraffic
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.params import params_from_jax
from repro_torch.serve import (BlockAllocator, BlockLeakError,
                               PagedServeConfig, PagedServingEngine,
                               PrefixRouter, PromptTooLongError, Request,
                               ServeConfig, ServingEngine, kv_token_bytes,
                               max_block_tokens, validate_prompt)
from repro_torch.serve import traffic

RULES = default_rules(None)
# f32 on both sides; only the summation order of the products differs
TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = {
    "llama3": ("llama3-8b", {}),
    "glm4": ("glm4-9b", {}),                        # kv=2, G=2
    "llama3-kv4": ("llama3-8b", {"n_kv_heads": 4}),  # no GQA, G=1
}
SCFG = dict(max_batch=4, max_seq=64, block_tokens=8, n_blocks=32)


def _setup(case):
    name, over = CONFIGS[case]
    jcfg = dataclasses.replace(jax_smoke_config(name), **over)
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pool_pair(cfg, rng, nb=12, bt=8):
    """A random pool leaf (NB, bt, Hkv, Dh) with block 0 zero, as numpy."""
    k, v = (rng.normal(size=(nb, bt, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    k[0] = v[0] = 0
    return k, v


# -- the paged layer -----------------------------------------------------------

@pytest.mark.parametrize("case", list(CONFIGS))
def test_attn_layer_decode_paged(case):
    """Three live slots at ragged positions (one writing into a fresh block)
    and two dead slots, one retired (zero table, pos 0) and one mid-prefill
    (a real table): the layer's output and the pool equal JAX's."""
    jcfg, cfg, jp, tp = _setup(case)
    jsp = jax.tree.map(lambda t: t[0], jp["period"]["l0"]["s0_attn"])
    sp = jax.tree.map(lambda t: t[0], tp["period"]["l0"]["s0_attn"])
    rng = np.random.default_rng(1)
    pk, pv = _pool_pair(cfg, rng)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 9, 0, 0],
                       [0, 0, 0, 0], [7, 8, 0, 0]], np.int32)
    pos = np.array([17, 9, 8, 0, 3], np.int32)
    live = np.array([True, True, True, False, False])
    x = rng.normal(size=(5, 1, cfg.d_model)).astype(np.float32)
    jy, jk, jv = JL.attn_layer_decode_paged(
        jsp, jnp.asarray(x), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(live), jcfg, RULES)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    pb = L.decode_batch(tables, pos, live, 8, "cpu")
    y = L.attn_layer_paged(sp, torch.from_numpy(x), tk, tv, pb, cfg)
    _close(y, jy)
    _close(tk, jk)
    _close(tv, jv)
    assert not tk[0].any() and not tv[0].any()      # the zero block


@pytest.mark.parametrize("start,valid", [(0, 16), (0, 5), (16, 11)])
@pytest.mark.parametrize("case", ["llama3", "glm4"])
def test_attn_layer_prefill_paged(case, start, valid):
    """A 16-token chunk over 8-token blocks: a first chunk, a short first
    chunk whose second block is unallocated, and a second chunk attending
    over the first chunk's resident blocks."""
    jcfg, cfg, jp, tp = _setup(case)
    jsp = jax.tree.map(lambda t: t[0], jp["period"]["l0"]["s0_attn"])
    sp = jax.tree.map(lambda t: t[0], tp["period"]["l0"]["s0_attn"])
    rng = np.random.default_rng(start + valid)
    pk, pv = _pool_pair(cfg, rng)
    used = -(-(start + valid) // 8)
    row = np.zeros(8, np.int32)
    row[:used] = [3, 9, 5, 2][:used]
    x = rng.normal(size=(1, 16, cfg.d_model)).astype(np.float32)
    jy, jk, jv = JL.attn_layer_prefill_paged(
        jsp, jnp.asarray(x), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(row), jnp.int32(start), jnp.int32(valid), jcfg, RULES)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    pb = L.chunk_batch(row, start, valid, 16, 8, "cpu")
    y = L.attn_layer_paged(sp, torch.from_numpy(x), tk, tv, pb, cfg)
    _close(y, jy)
    _close(tk, jk)
    _close(tv, jv)
    assert not tk[0].any() and not tv[0].any()


# -- the paged model steps ---------------------------------------------------

def _pools(jcfg, cfg, rng, nb=12, bt=8):
    """The same random pool tree for both frameworks (block 0 zero)."""
    jdefs = jlm.pool_defs(jcfg, nb, bt)
    jpool = jax.tree.map(
        lambda pv: np.where(np.arange(nb)[None, :, None, None, None] == 0, 0,
                            rng.normal(size=pv.shape)).astype(np.float32),
        jdefs, is_leaf=lambda x: hasattr(x, "logical"))
    tpool = params_from_jax(jpool)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, jpool)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tpool))
    return jax.tree.map(jnp.asarray, jpool), tpool


def test_decode_step_paged_and_prefill_chunk_match_jax():
    jcfg, cfg, jp, tp = _setup("llama3")
    rng = np.random.default_rng(5)
    jpool, tpool = _pools(jcfg, cfg, rng)
    tables = np.array([[1, 2, 0, 0], [3, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([12, 5, 0], np.int32)
    live = np.array([True, True, False])
    tok = rng.integers(1, cfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jpool = jlm.decode_step_paged(jp, jnp.asarray(tok), jpool,
                                      jnp.asarray(tables), jnp.asarray(pos),
                                      jnp.asarray(live), jcfg, RULES)
    tl, tpool = lm.decode_step_paged(tp, torch.from_numpy(tok).long(), tpool,
                                     tables, pos, live, cfg)
    _close(tl, jl)
    row = np.array([4, 5, 0, 0, 0, 0, 0, 0], np.int32)
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :11] = rng.integers(1, cfg.vocab_size, 11)
    jl, jpool = jlm.prefill_chunk(jp, jnp.asarray(chunk), jpool,
                                  jnp.asarray(row), jnp.int32(0),
                                  jnp.int32(11), jcfg, RULES)
    tl, tpool = lm.prefill_chunk(tp, torch.from_numpy(chunk).long(), tpool,
                                 row, 0, 11, cfg)
    assert tl.shape == (1, 16, cfg.padded_vocab)     # every row's logits
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tpool["l0"]["s0_attn"][key], jpool["l0"]["s0_attn"][key])


def test_pool_defs_refuses_windowed_configs():
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), window=8)
    with pytest.raises(ValueError, match="full attention"):
        lm.pool_defs(cfg, 4, 8)


# -- the engine ----------------------------------------------------------------

def _prompts(vocab):
    """``check_serve_paged``'s prompt set: duplicates adjacent to their
    originals, so the sharing pairs are admitted in the same wave."""
    rng = np.random.default_rng(0)
    base = [rng.integers(1, vocab, int(rng.integers(5, 20))).astype(np.int32)
            for _ in range(4)]
    return [base[0], base[0].copy(), base[1], base[1].copy(), base[2], base[3]]


def _drive(engine, prompts, req=Request):
    reqs = [req(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.rid: list(r.out) for r in reqs}


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_paged_engine_streams_and_counters_match_jax(case, chunk):
    jcfg, cfg, jp, tp = _setup(case)
    prompts = _prompts(cfg.vocab_size)
    jeng = JPagedServingEngine(jcfg, jp, RULES,
                               JPagedServeConfig(**SCFG, chunk=chunk))
    eng = PagedServingEngine(lm.Model(cfg, tp), PagedServeConfig(**SCFG, chunk=chunk),
                             device="cpu")
    want = _drive(jeng, prompts, JRequest)
    assert _drive(eng, prompts) == want
    assert eng.alloc.shared_hits == jeng.alloc.shared_hits
    assert eng.cow_copies == jeng.cow_copies
    assert eng.prefill_chunks == jeng.prefill_chunks
    assert eng.decode_steps == jeng.decode_steps
    assert eng.alloc.peak_allocated == jeng.alloc.peak_allocated
    eng.shutdown()
    for leaf in jax.tree.leaves(eng.pool):
        assert not leaf[:, 0].any(), "zero block written"


@pytest.mark.parametrize("chunk", [0, 16])
def test_paged_streams_equal_dense_streams(chunk):
    """The block table, COW sharing and the zero block are invisible to
    the math: the port's paged streams are its dense engine's."""
    _, cfg, _, tp = _setup("llama3")
    model = lm.Model(cfg, tp)
    prompts = _prompts(cfg.vocab_size)
    dense = ServingEngine(model, ServeConfig(max_batch=4, max_seq=64),
                          device="cpu")
    paged = PagedServingEngine(model, PagedServeConfig(**SCFG, chunk=chunk),
                               device="cpu")
    assert _drive(paged, prompts) == _drive(dense, prompts)
    # chunked prefill publishes a prompt's blocks only once it is complete,
    # so duplicates admitted in the same wave share nothing
    if not chunk:
        assert paged.alloc.shared_hits >= 1 and paged.cow_copies >= 1
    assert (paged.prefill_chunks > 0) == bool(chunk)


def test_paged_engine_records_its_own_spans():
    _, cfg, _, tp = _setup("llama3")
    for chunk in (0, 16):
        eng = PagedServingEngine(lm.Model(cfg, tp),
                                 PagedServeConfig(**SCFG, chunk=chunk),
                                 device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(_prompts(cfg.vocab_size))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        tm = eng.timing
        assert tm["decode_steps"] > 0 and tm["decode_s"] > 0
        if chunk:
            assert tm["chunks"] >= 6 and tm["chunk_s"] > 0 and tm["prefills"] == 0
        else:
            assert tm["prefills"] == 6 and tm["prefill_s"] > 0 and tm["chunks"] == 0
        assert all(0 < r.t_submit <= r.t_first for r in reqs)


@pytest.mark.parametrize("bad", ["window", "block_tokens", "max_seq", "chunk"])
def test_paged_engine_refuses_bad_configs(bad):
    _, cfg, _, tp = _setup("llama3")
    scfg = dict(SCFG)
    if bad == "window":
        cfg = dataclasses.replace(cfg, window=8)
    elif bad == "block_tokens":                 # not dividing the kernel's round
        scfg.update(block_tokens=2 * max_block_tokens(cfg), max_seq=1024)
    elif bad == "max_seq":
        scfg.update(max_seq=60)
    else:
        scfg.update(chunk=12)
    with pytest.raises(ValueError):
        PagedServingEngine(lm.Model(cfg, tp), PagedServeConfig(**scfg),
                           device="cpu")


def test_router_affinity():
    """A repeated prompt routes back to the pod that served it first, even
    with the other pod idle (``check_serve_paged`` step 5), as in JAX."""
    jcfg, cfg, jp, tp = _setup("llama3")
    model = lm.Model(cfg, tp)
    prompts = _prompts(cfg.vocab_size)
    pods = {}
    for name, router, req in (
            ("jax", JPrefixRouter([JPagedServingEngine(
                jcfg, jp, RULES, JPagedServeConfig(**SCFG)) for _ in range(2)]),
             JRequest),
            ("port", PrefixRouter([PagedServingEngine(
                model, PagedServeConfig(**SCFG), device="cpu")
                for _ in range(2)]), Request)):
        stream = [req(rid=i, prompt=p, max_new_tokens=8)
                  for i, p in enumerate(prompts)]
        first = router.submit(stream[0])
        router.run()
        for r in stream[2:]:
            router.submit(r)
        router.run()
        dup = router.submit(stream[1])
        router.run()
        assert dup == first and router.affinity_hits >= 1
        pods[name] = (first, list(router.routed), router.affinity_hits,
                      {r.rid: r.out for r in router.finished})
    assert pods["port"] == pods["jax"]


# -- the allocator and submit gate (``tests/test_serve_paged.py``) -----------

def _bookkeeping():
    a = BlockAllocator(4, 8)
    assert a.n_free == 4 and a.n_allocated == 0
    b1, b2 = a.alloc(), a.alloc()
    assert (b1, b2) == (1, 2)               # lowest ids first, 0 reserved
    assert a.n_allocated == 2 and a.peak_allocated == 2
    a.release(b1)
    assert a.n_free == 3
    assert a.alloc() == 1                   # freed id comes back
    a.release(1)
    a.release(b2)
    assert a.n_allocated == 0 and a.peak_allocated == 2


def _exhaustion():
    a = BlockAllocator(2, 8)
    a.alloc(), a.alloc()
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc()


def _refcount_sharing():
    a = BlockAllocator(4, 8)
    key = ("full", (1, 2, 3))
    bid = a.alloc(key)
    assert a.lookup(key) == bid
    a.retain(bid)
    assert a.refcount[bid] == 2 and a.shared_hits == 1
    a.release(bid)                          # one sharer gone: still keyed
    assert a.refcount[bid] == 1 and a.lookup(key) == bid
    a.release(bid)                          # last ref: key dropped, freed
    assert a.lookup(key) is None and a.n_allocated == 0


def _first_writer_wins():
    a = BlockAllocator(4, 8)
    key = ("part", (9, 9))
    b1 = a.alloc(key)
    b2 = a.alloc(key)                       # duplicate content: stays private
    assert a.lookup(key) == b1
    a.forget_key(b2)                        # no-op: b2 never owned the key
    assert a.lookup(key) == b1
    a.forget_key(b1)                        # pre-divergence unpublish
    assert a.lookup(key) is None
    assert a.refcount[b1] == 1              # forget does not free


def _validate_prompt_boundary():
    assert validate_prompt(np.arange(63, dtype=np.int32), 64) == 63
    with pytest.raises(PromptTooLongError, match="64-position cache"):
        validate_prompt(np.arange(64, dtype=np.int32), 64)
    with pytest.raises(ValueError, match="empty"):
        validate_prompt(np.zeros(0, np.int32), 64)


def _quiescent_when_clean():
    a = BlockAllocator(4, 8)
    b = a.alloc(("prefix", (1, 2)))
    a.retain(b)
    a.release(b)
    a.release(b)
    a.assert_quiescent()


def _quiescent_names_live_refcounts():
    a = BlockAllocator(4, 8)
    b1, b2 = a.alloc(), a.alloc()
    a.release(b1)
    with pytest.raises(BlockLeakError, match="live refcounts"):
        a.assert_quiescent()
    a.release(b2)
    a.assert_quiescent()


def _quiescent_catches_stale_registry():
    a = BlockAllocator(4, 8)
    b = a.alloc(("k", (7,)))
    a.release(b)
    a.assert_quiescent()
    a._prefix[("stale", (0,))] = 3          # inject the violation
    with pytest.raises(BlockLeakError, match="registry"):
        a.assert_quiescent()


def _engine_shutdown():
    _, cfg, _, tp = _setup("llama3")
    eng = PagedServingEngine(lm.Model(cfg, tp),
                             PagedServeConfig(max_batch=2, max_seq=32,
                                              block_tokens=8, n_blocks=8),
                             device="cpu")
    bad = Request(rid=9, prompt=np.ones(32, np.int32), max_new_tokens=4)
    with pytest.raises(PromptTooLongError):
        eng.submit(bad)
    assert eng.n_waiting == 0               # rejected before enqueue
    eng.submit(Request(rid=0, prompt=np.ones(8, np.int32), max_new_tokens=2))
    with pytest.raises(BlockLeakError, match="in flight"):
        eng.shutdown()                      # still queued
    eng.run()
    eng.shutdown()                          # clean: no raise
    leaked = eng.alloc.alloc()              # inject a leaked reservation
    with pytest.raises(BlockLeakError, match="live refcounts"):
        eng.shutdown()
    eng.alloc.release(leaked)
    eng.shutdown()


ALLOCATOR_CASES = {f.__name__[1:]: f for f in (
    _bookkeeping, _exhaustion, _refcount_sharing, _first_writer_wins,
    _validate_prompt_boundary, _quiescent_when_clean,
    _quiescent_names_live_refcounts, _quiescent_catches_stale_registry,
    _engine_shutdown)}


@pytest.mark.parametrize("case", list(ALLOCATOR_CASES))
def test_allocator(case):
    ALLOCATOR_CASES[case]()


def test_block_sizing_is_the_kernels_limit():
    """The cap is the paged kernel's, not the JAX package's TPU budget: a
    block divides its 64-token round, and a round's K/V tiles fit the
    card's shared memory at every config the port serves."""
    from repro_torch.kernels import paged_attention as pa
    full = dataclasses.replace(get_smoke_config("llama3-8b"), d_head=128,
                               n_heads=32, n_kv_heads=8)
    for cfg in (full, get_smoke_config("llama3-8b"), get_smoke_config("glm4-9b")):
        assert max_block_tokens(cfg) == pa.TOKENS_PER_ROUND == 64
        G = cfg.n_heads // cfg.n_kv_heads
        assert cfg.head_dim in pa.HEAD_DIMS and G <= pa.MAX_G
        for B in (1, 8, 128):                   # decode batches, a 128-row chunk
            p = pa.plan(B, cfg.n_kv_heads, G, 1024)
            for isz in (2, 4):
                assert pa.smem_bytes(cfg.head_dim, isz, p.stages) <= pa.SMEM_BYTES
    assert kv_token_bytes(full) == 2 * 8 * 128 * 4 * full.n_layers


# -- open-loop traffic -------------------------------------------------------

def test_prompt_pool_and_schedule_match_jax():
    lc = traffic.LoadConfig(n_requests=10, pool_size=5, seed=3)
    jlc = jtraffic.LoadConfig(n_requests=10, pool_size=5, seed=3)
    for a, b in zip(traffic.prompt_pool(lc), jtraffic.prompt_pool(jlc)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(traffic.request_schedule(lc), jtraffic.request_schedule(jlc)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("front", ["paged_chunked", "router"])
def test_run_open_loop_on_the_cpu(front):
    _, cfg, _, tp = _setup("llama3")
    model = lm.Model(cfg, tp)
    make = lambda chunk: PagedServingEngine(
        model, PagedServeConfig(**SCFG, chunk=chunk), device="cpu")
    eng = make(16) if front == "paged_chunked" else PrefixRouter([make(0), make(0)])
    lc = traffic.LoadConfig(n_requests=8, rate_rps=500.0, max_new=6)
    m = traffic.run_open_loop(eng, lc)
    assert m["completed"] == 8 and m["n_requests"] == 8
    assert 0 <= m["ttft_p50_ms"] <= m["ttft_p99_ms"]
    assert m["decode_tok_s"] > 0 and 1 <= m["max_concurrent"] <= eng.capacity
    assert len(eng.finished) == 8
    for e in getattr(eng, "engines", [eng]):
        e.shutdown()


def test_run_open_loop_waits_for_arrivals():
    """Idle steps before an arrival do not use up ``max_steps``: an engine
    that is idle for 0.3 s between arrivals still serves every request
    within a budget of 200 steps (counting idle steps, the loop gave up
    after 200 fast idle steps with requests still to come)."""
    _, cfg, _, tp = _setup("llama3")
    eng = PagedServingEngine(lm.Model(cfg, tp), PagedServeConfig(**SCFG),
                             device="cpu")
    lc = traffic.LoadConfig(n_requests=3, rate_rps=3.0, max_new=2)
    m = traffic.run_open_loop(eng, lc, max_steps=200)
    assert m["completed"] == 3 and m["wall_s"] >= traffic.request_schedule(lc)[0][-1]
    eng.shutdown()


def test_traffic_cli_on_the_cpu(capsys):
    assert traffic.main(["--device", "cpu", "--requests", "4", "--rate", "500",
                         "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    for tag in ("dense", "paged", "paged_chunked"):
        assert f"serve/{tag}," in out
    assert out.count("serve_json ") == 3
