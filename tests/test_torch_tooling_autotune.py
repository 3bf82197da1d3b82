"""The port's autotuner (``repro_torch.kernels.autotune``) on the CPU: its
signatures and cache format are the reference's, its loop (enumerate ->
rank -> measure -> cache -> agreement) runs with measurements injected in
place of the card, its ranking is deterministic and every candidate is a
legal Hopper plan, the wrappers read a table only inside ``tuned()``, and a
tuned table leaves the CPU path's bits as they are (the twin of the
reference's ``test_layers_bit_identical_tuned_vs_untuned``)."""
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import autotune as at
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hopper
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import reduction as red
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import stencil as st
from repro_torch.models import lm
from repro_torch.params import init_params
from repro_torch.testing import timing

TAG = "test-card"
#: one signature a family, at small shapes of each plan's kind
CASES = [("matmul", (4, 4096, 1024), "bfloat16"), ("matmul", (128, 4096, 4096), "bfloat16"),
         ("matmul", (333, 4096, 1024, 1), "bfloat16"), ("matmul", (7, 100, 24), "float32"),
         ("flash_attention", (1, 32, 8, 223, 223, 128), "bfloat16"),
         ("flash_attention", (1, 4, 2, 64, 64, 32), "float32"),
         ("paged_attention", (8, 32, 8, 1024, 128), "bfloat16"),
         ("rmsnorm", (4, 4096), "bfloat16"), ("rmsnorm", (4096, 4096), "float32"),
         ("reduction", (2 ** 28,), "float32"), ("reduction", (4096,), "float32"),
         ("stencil", (256, 4096), "float32")]


def _fake_measure(calls: list):
    """A card stand-in: the model's µs, bent by a fixed per-config factor,
    so the measured order is not the model's everywhere."""
    def measure(kernel, shape, dtype, cfg):
        calls.append((kernel, tuple(shape), dtype, dict(cfg)))
        bend = 1.0 + (sum(map(ord, json.dumps(cfg, sort_keys=True))) % 7) / 10
        us = at.model_cost_us(kernel, shape, dtype, cfg) * bend
        return timing.Sample(us, 0.01 * us, 5), {"limit_use": 0.25, "ok": True}
    return measure


@pytest.mark.parametrize("kernel,shape,dtype", [
    ("matmul", (128, 128, 128), "float32"), ("paged_attention", (8, 32, 8, 1024, 128),
                                             "bfloat16"), ("reduction", (65536,), "float32")])
def test_signature_is_the_references(kernel, shape, dtype):
    for tag in (TAG, "16x4", "NVIDIA H100 80GB HBM3"):
        assert at.signature(kernel, shape, dtype, tag) == \
            jat.signature(kernel, shape, dtype, tag)
    assert at.signature(kernel, shape, getattr(torch, dtype), TAG) == \
        jat.signature(kernel, shape, dtype, TAG)


def test_families_are_the_references():
    assert at.KERNELS == jat.KERNELS and set(at.DEFAULTS) == set(jat.DEFAULTS)


def test_cache_file_has_the_references_schema_and_keys(tmp_path):
    """The same file format: ``{"schema": 1, "entries": {sig: record}}``
    with the reference's record keys and candidate keys (the port's
    candidates add ``limit_use``, the check's share of its limit)."""
    with jat.tuned(tmp_path / "jax.json", top_k=1, reps=1, warmup=0) as jctx:
        jrec = jat.autotune("rmsnorm", (16, 256), ctx=jctx)
    with at.tuned(tmp_path / "port.json", topology_tag=TAG,
                  measure=_fake_measure([])) as ctx:
        rec = at.autotune("rmsnorm", (16, 256), "float32", ctx=ctx)
    jdoc = json.loads((tmp_path / "jax.json").read_text())
    doc = json.loads((tmp_path / "port.json").read_text())
    assert set(doc) == set(jdoc) == {"schema", "entries"}
    assert doc["schema"] == jdoc["schema"] == 1
    assert set(rec) == set(jrec)
    (jsig, jr), (sig, r) = *jdoc["entries"].items(), *doc["entries"].items()
    assert set(r) == set(jr)
    jkeys = {k for e in jr["candidates"] for k in e}
    keys = {k for e in r["candidates"] for k in e}
    assert keys - jkeys == {"limit_use"} and jkeys <= keys
    assert sig.split("|")[:3] == jsig.split("|")[:3]


@pytest.mark.parametrize("kernel,shape,dtype", CASES)
def test_the_loop_with_injected_measurements(tmp_path, kernel, shape, dtype):
    calls = []
    with at.tuned(tmp_path / "c.json", top_k=3, topology_tag=TAG,
                  measure=_fake_measure(calls)) as ctx:
        rec = at.autotune(kernel, shape, dtype, ctx=ctx)
        n = len(calls)
        assert at.autotune(kernel, shape, dtype, ctx=ctx) == rec   # cached
        assert len(calls) == n
        full = at.autotune(kernel, shape, dtype, ctx=ctx, measure_all=True)
    cands = at.enumerate_candidates(kernel, shape, dtype)
    assert n == min(3, len(cands)) and len(calls) == n + len(cands)
    measured = [e for e in full["candidates"] if "measured_us" in e]
    assert len(measured) == len(cands)
    win = min(measured, key=lambda e: (e["measured_us"], e["model_rank"]))
    assert full["winner"] == win["config"]
    assert full["agreement_at_k"] == (full["model_rank_of_winner"] < 3)
    assert [e["model_rank"] for e in full["candidates"]] == list(range(len(cands)))
    doc = json.loads((tmp_path / "c.json").read_text())
    assert doc["entries"][at.signature(kernel, shape, dtype, TAG)]["winner"] == \
        full["winner"]
    with at.tuned(tmp_path / "c.json", topology_tag=TAG) as again:
        assert at.tuned_config(kernel, shape, dtype) == full["winner"]
        assert again.lookup(kernel, shape, dtype) == full["winner"]


@pytest.mark.parametrize("kernel,shape,dtype", CASES)
def test_candidates_are_legal_hopper_plans_ranked_deterministically(kernel, shape, dtype):
    cands = at.enumerate_candidates(kernel, shape, dtype)
    assert cands and at.default_config(kernel, shape, dtype) in cands
    assert cands == at.enumerate_candidates(kernel, shape, dtype)
    for cfg in cands:
        assert at.is_legal(kernel, shape, dtype, cfg), cfg
        r = at.block_resources(kernel, shape, dtype, cfg)
        assert 0 < r["threads"] <= hopper.MAX_THREADS
        assert r["smem"] <= (hopper.STATIC_SMEM_BYTES if r["static"]
                             else hopper.BLOCK_SMEM_BYTES)
        assert r["blocks"] >= 1
    ranked = at.rank_candidates(kernel, shape, dtype, cands)
    assert ranked == at.rank_candidates(kernel, shape, dtype, list(reversed(cands)))
    us = [u for _, u in ranked]
    assert us == sorted(us) and all(u > 0 and math.isfinite(u) for u in us)


def test_a_family_with_one_plan_has_that_plan_alone():
    """jacobi2d's launch has no knob: its one plan is empty."""
    assert at.enumerate_candidates("stencil", (16384, 16384), "float32") == [{}]
    assert at.enumerate_candidates("flash_attention", (1, 4, 2, 64, 64, 32),
                                   "bfloat16") == [{"variant": "simt"}]
    assert at.enumerate_candidates("matmul", (7, 100, 24), "float32") == [{"splits": 1}]


def test_autotune_outside_tuned_refuses_and_leaves_the_plans_alone():
    """The default context keeps no table: autotune() without a context of
    its own raises, nothing can be written into the default, and the
    wrappers still take their own rules."""
    sig = ("matmul", (128, 4096, 4096), "bfloat16")
    with pytest.raises(RuntimeError, match="outside tuned"):
        at.autotune(*sig)
    with pytest.raises(TypeError):
        at.current().table[at.signature(*sig, TAG)] = {"winner": {"splits": 2}}
    with pytest.raises(RuntimeError):
        at.current().save()
    assert not at.current().table and at.tuned_config(*sig) is None
    assert mm.plan("wgmma", 128, 4096, 4096) == mm.default_plan("wgmma", 128, 4096, 4096)
    assert rms.tuned_bwd_blocks(4096, 4096, torch.float32) == rms.bwd_blocks(4096)


def test_a_table_that_is_not_one_raises(tmp_path):
    """A missing file is an empty table (the autotuner starts one); a file
    that is not a table of the reference's format raises at the first read,
    so that no run takes untuned plans while its caller believes them
    tuned; a winner that is not a legal plan raises at the wrapper."""
    sig = ("rmsnorm", (4096, 4096), "float32")
    with at.tuned(tmp_path / "none.json", topology_tag=TAG) as ctx:
        assert at.tuned_config(*sig) is None and ctx.table == {} and ctx.hits == 0
    for bad in ("{not json", json.dumps([1, 2]), json.dumps({"entries": {}}),
                json.dumps({"schema": 1, "entries": []})):
        (tmp_path / "bad.json").write_text(bad)
        with at.tuned(tmp_path / "bad.json", topology_tag=TAG):
            with pytest.raises(ValueError, match="autotune table"):
                at.tuned_config(*sig)
    (tmp_path / "ok.json").write_text(json.dumps({"schema": 1, "entries": {
        at.signature(*sig, TAG): {"winner": {"bwd_blocks": 66}}}}))
    with at.tuned(tmp_path / "ok.json", topology_tag=TAG) as ctx:
        assert rms.tuned_bwd_blocks(4096, 4096, torch.float32) == 66 and ctx.hits == 1
    for winner in ({"bwd_blocks": 0}, {"bwd_blocks": 5000}, {"blocks": 66}, {}):
        ctx = at.TuneContext(topology_tag=TAG)
        ctx.table[at.signature(*sig, TAG)] = {"winner": winner}
        with at.tuned(ctx), pytest.raises(ValueError, match="not a legal plan"):
            rms.tuned_bwd_blocks(4096, 4096, torch.float32)


@pytest.mark.parametrize("kernel,shape,dtype", CASES)
def test_block_resources_are_the_kernel_modules(kernel, shape, dtype):
    """The autotuner states no block of its own: each family's resources and
    legality are its kernel module's, beside its plan rule."""
    for cfg in at.enumerate_candidates(kernel, shape, dtype):
        r = at.block_resources(kernel, shape, dtype, cfg)
        if kernel == "matmul":
            M, K, N, trans = at._mm_dims(shape)
            kind = mm.variant(M, K, N, getattr(torch, dtype), trans=trans)
            assert r == mm.block_resources(kind, M, K, N, trans, cfg["splits"])
        elif kernel == "flash_attention":
            B, Hq, _, S, _, D = shape
            assert r == fa.block_resources(cfg["variant"], B, Hq, S, D)
        elif kernel == "paged_attention":
            B, Hq, Hkv, T, D = shape
            assert r == pa.block_resources(B, Hkv, Hq // Hkv, T, D, 2, cfg["splits"])
        elif kernel == "stencil":
            assert r == st.jacobi_block_resources(*shape)


def _csrc_int(name: str, pattern: str) -> int:
    """An integer constant of a kernel's CUDA source."""
    import re
    src = (pathlib.Path(mm.__file__).parent / "csrc" / name).read_text()
    return int(re.search(pattern, src).group(1))


def test_the_kernel_modules_blocks_are_their_sources():
    """The threads and tiles the modules state are the csrc constants the
    launches use (a kernel that changes its block changes them here)."""
    assert mm.WGMMA_THREADS == _csrc_int("matmul.cu", r"namespace wg \{[^}]*?THREADS = (\d+)")
    assert mm.BWD_THREADS == _csrc_int("matmul.cu", r"namespace pw \{[^}]*?THREADS = (\d+)")
    assert mm.DECODE_THREADS == _csrc_int("matmul.cu", r"namespace dec \{[^}]*?THREADS = (\d+)")
    assert mm.DECODE_STAGES == _csrc_int("matmul.cu", r"namespace dec \{[^}]*?STAGES = (\d+)")
    assert fa.WGMMA_THREADS == _csrc_int("flash_attention.cu",
                                         r"namespace fw \{[^}]*?THREADS = (\d+)")
    assert fa.WGMMA_STAGES == _csrc_int("flash_attention.cu",
                                        r"namespace fw \{[^}]*?STAGES = (\d+)")
    assert fa.SIMT_THREADS == _csrc_int("flash_attention.cu", r"constexpr int NT = (\d+)")
    assert st.JACOBI_TILE == (_csrc_int("stencil.cu", r"constexpr int BH = (\d+)"),
                              _csrc_int("stencil.cu", r"BH = \d+, BW = (\d+)"))
    assert st.JACOBI_THREADS == _csrc_int("stencil.cu", r"constexpr int THREADS = (\d+)")
    assert red.DOT_THREADS == _csrc_int("reduction.cu", r"constexpr int DOT_THREADS = (\d+)")
    for r in (mm.block_resources("wgmma", 4096, 4096, 4096, 0),
              mm.block_resources("wgmma", 4096, 4096, 4096, 1),
              fa.block_resources("wgmma", 1, 32, 512, 128)):
        assert r["smem"] <= hopper.BLOCK_SMEM_BYTES


def test_the_cost_model_generalises_wgmma_plans_rule():
    """A split pays where the tiles leave SMs idle, not where they fill the
    card; and the model's split charge is ``WGMMA_SPLIT_US``."""
    assert at.model_cost_us("matmul", (128, 14336, 4096), "bfloat16", {"splits": 4}) < \
        at.model_cost_us("matmul", (128, 14336, 4096), "bfloat16", {"splits": 1})
    assert at.model_cost_us("matmul", (4096, 4096, 4096), "bfloat16", {"splits": 1}) > 0
    assert at.enumerate_candidates("matmul", (4096, 4096, 4096), "bfloat16") == \
        [{"splits": 1}]
    c2 = at.model_cost("matmul", (128, 4096, 4096), "bfloat16", {"splits": 2})
    assert c2["split_us"] == mm.WGMMA_SPLIT_US


def test_tuned_contexts_nest_and_no_table_is_read_outside(tmp_path, monkeypatch):
    reads = []
    real = pathlib.Path.read_text
    monkeypatch.setattr(pathlib.Path, "read_text",
                        lambda self, *a, **k: reads.append(self) or real(self, *a, **k))
    base = at.current()
    assert base.cache_path is None and not base.table
    sig = ("matmul", (128, 4096, 4096), "bfloat16")
    assert at.tuned_config(*sig) is None
    (tmp_path / "a.json").write_text(json.dumps({"schema": 1, "entries": {
        at.signature(*sig, TAG): {"winner": {"splits": 3}}}}))
    with at.tuned(tmp_path / "a.json", topology_tag=TAG) as a:
        assert at.current() is a and at.tuned_config(*sig) == {"splits": 3}
        with at.tuned(topology_tag=TAG) as b:
            assert at.current() is b and at.tuned_config(*sig) is None
            b.table[at.signature(*sig, TAG)] = {"winner": {"splits": 4}}
            assert at.tuned_config(*sig) == {"splits": 4}
        assert at.current() is a and at.tuned_config(*sig) == {"splits": 3}
    assert at.current() is base and at.tuned_config(*sig) is None
    assert reads == [tmp_path / "a.json"]
    reads.clear()
    # the wrappers' plan reads outside tuned(): today's rules, no file read
    assert mm.plan("wgmma", 128, 4096, 4096) == mm.default_plan("wgmma", 128, 4096, 4096)
    assert pa.tuned_plan(8, 8, 4, 128, 16, 64, torch.bfloat16) == pa.plan(8, 8, 4, 1024)
    assert rms.tuned_bwd_blocks(4096, 4096, torch.float32) == rms.bwd_blocks(4096)
    assert red.tuned_dot_blocks(2 ** 20, torch.float32) == \
        red.dot_blocks(red.dot_seg_len(2 ** 20))
    assert fa.tuned_variant(1, 32, 8, 223, 223, 128, torch.bfloat16) == "wgmma"
    assert reads == []


def test_the_wrappers_plans_follow_the_table():
    ctx = at.TuneContext(topology_tag=TAG)
    entries = {("matmul", (128, 4096, 4096), "bfloat16"): {"splits": 3},
               ("matmul", (333, 4096, 1024, 1), "bfloat16"): {"splits": 2},
               ("matmul", (4, 4096, 1024), "bfloat16"): {"splits": 4},
               ("paged_attention", (8, 32, 8, 1024, 128), "bfloat16"): {"bt": 16, "splits": 2},
               ("rmsnorm", (4096, 4096), "float32"): {"bwd_blocks": 66},
               ("reduction", (2 ** 20,), "float32"): {"blocks": 33},
               ("flash_attention", (1, 32, 8, 223, 223, 128), "bfloat16"): {"variant": "simt"}}
    for (k, s, d), cfg in entries.items():
        ctx.table[at.signature(k, s, d, TAG)] = {"winner": cfg}
    with at.tuned(ctx):
        assert mm.plan("wgmma", 128, 4096, 4096)[0] == 3
        assert mm.plan("wgmma", 333, 4096, 1024, 1)[0] == 2
        assert mm.plan("wgmma", 333, 4096, 1024, 2) == mm.default_plan("wgmma", 333, 4096, 1024, 2)
        assert mm.plan("decode", 4, 4096, 1024) == mm.plan_with_splits("decode", 4, 4096, 1024, 0, 4)
        assert pa.tuned_plan(8, 8, 4, 128, 16, 64, torch.bfloat16).splits == 2
        assert pa.tuned_plan(8, 8, 4, 128, 32, 32, torch.bfloat16) == pa.plan(8, 8, 4, 1024)
        assert rms.tuned_bwd_blocks(4096, 4096, torch.float32) == 66
        assert red.tuned_dot_blocks(2 ** 20, torch.float32) == 33
        assert fa.tuned_variant(1, 32, 8, 223, 223, 128, torch.bfloat16) == "simt"
        ctx.table[at.signature("matmul", (128, 4096, 4096), "bfloat16", TAG)] = \
            {"winner": {"splits": 64}}
        with pytest.raises(ValueError, match="not a legal plan"):
            mm.plan("wgmma", 128, 4096, 4096)


def test_the_serving_launchers_block_follows_the_table():
    from repro_torch.launch import serve
    cfg = get_smoke_config("llama3-8b")
    assert serve._block_tokens(cfg, 4, 128) == 16
    ctx = at.TuneContext(topology_tag=TAG)
    ctx.table[at.signature("paged_attention", (4, cfg.n_heads, cfg.n_kv_heads, 128,
                                               cfg.head_dim), cfg.dtype, TAG)] = \
        {"winner": {"bt": 32, "splits": 1}}
    with at.tuned(ctx):
        assert serve._block_tokens(cfg, 4, 128) == 32
        assert serve._block_tokens(cfg, 4, 96) == 16      # another signature
    assert serve._block_tokens(cfg, 4, 128) == 16


def test_layers_bit_identical_tuned_vs_untuned():
    """forward_train, and dense and paged greedy streams, under a table that
    rigs every family's plan: the CPU path's bits are the untuned path's
    (on the CPU the plain versions take no plan), and paged = dense."""
    from repro_torch.serve import (PagedServeConfig, PagedServingEngine, Request,
                                   ServeConfig, ServingEngine)
    cfg = get_smoke_config("llama3-8b")
    params = init_params(lm.model_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 17, 30)]

    def run():
        loss = lm.forward_train(params, tokens, cfg)
        model = lm.Model(cfg, params)
        streams = []
        for eng in (ServingEngine(model, ServeConfig(max_batch=2, max_seq=64), device="cpu"),
                    PagedServingEngine(model, PagedServeConfig(
                        max_batch=2, max_seq=64, block_tokens=16, n_blocks=8),
                        device="cpu")):
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
            streams.append({r.rid: list(r.out) for r in eng.run()})
        return loss, streams

    base_loss, base_streams = run()
    ctx = at.TuneContext(topology_tag=TAG)
    hd, S = cfg.head_dim, 32
    for k, s, d, w in [
            ("flash_attention", (2, cfg.n_heads, cfg.n_kv_heads, S, S, hd), cfg.dtype,
             {"variant": "simt"}),
            ("matmul", (64, cfg.d_model, cfg.d_ff), "bfloat16", {"splits": 2}),
            ("rmsnorm", (64, cfg.d_model), cfg.dtype, {"bwd_blocks": 3}),
            ("paged_attention", (2, cfg.n_heads, cfg.n_kv_heads, 64, hd), cfg.dtype,
             {"bt": 16, "splits": 2})]:
        ctx.table[at.signature(k, s, d, TAG)] = {"winner": w}
    with at.tuned(ctx):
        loss, streams = run()
    assert torch.equal(loss, base_loss)
    assert streams == base_streams and streams[0] == streams[1]


def test_fit_recovers_the_step_and_split_costs():
    """Samples made by ``c + step * ceil(k_steps / n) + split * (n - 1)``
    give back step and split exactly."""
    recs = []
    for M, K, N, c in ((128, 4096, 4096, 3.0), (128, 14336, 4096, 5.0),
                       (333, 4096, 1024, 2.0)):
        k_steps = math.ceil(K / mm.WGMMA_BK)
        recs.append({"shape": [M, K, N], "candidates": [
            {"config": {"splits": n},
             "measured_us": c + 0.31 * math.ceil(k_steps / n) + 4.2 * (n - 1)}
            for n in mm.legal_splits("wgmma", M, K, N)]})
    fit = at.fit_wgmma_costs(recs)
    assert fit["step_us"] == pytest.approx(0.31) and fit["split_us"] == pytest.approx(4.2)
    assert fit["rms_us"] < 1e-9 and len(fit["shapes"]) == 3
    assert at.fit_wgmma_costs(recs[:0])["step_us"] is None


def test_timing_sample_on_the_host_clock():
    x = torch.ones(8)
    s = timing.measure_us(lambda t: t + 1, x, reps=5, warmup=1)
    assert isinstance(s, timing.Sample) and s.reps == 5
    assert s.median_us > 0 and s.iqr_us >= 0
    assert timing.median_time_us(lambda t: t + 1, x, reps=3, warmup=0) > 0


def test_timing_rotates_copies_of_the_operands():
    """``copies``: the calls take the arguments and their clones in turn,
    strides kept; a measurement rotates enough copies to hold twice the
    L2 (one where a copy already does)."""
    x = torch.arange(12.0).reshape(3, 4).t()
    seen = []
    timing.measure_us(lambda t, k: seen.append((t.data_ptr(), t.stride(), k)), x, 7,
                      reps=3, warmup=1, copies=3)
    assert len({p for p, _, _ in seen}) == 3 and {s for _, s, _ in seen} == {x.stride()}
    assert {k for _, _, k in seen} == {7} and len(seen) == 5
    assert at.rotation((torch.empty(4, 4096, dtype=torch.bfloat16),)) == \
        math.ceil(2 * hopper.L2_BYTES / (4 * 4096 * 2))
    assert at.rotation((torch.empty(2 ** 20, 64), 3)) == 1


def test_cli_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    assert at.main(["--smoke"]) == 2
    assert "no CUDA card" in capsys.readouterr().out
