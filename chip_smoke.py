#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA libraries (matmul, flash_attention, paged_attention;
     one nvcc each, all at once, sm_90a) and the Triton rmsnorm;
  3. each kernel against its plain PyTorch version on the card, element by
     element, at the llama3-8b serving shapes, in bf16 and f32;
  4. the llama3-8b smoke model (f32, seeded weights): logits and greedy
     token streams of the kernel path on the card against the plain path
     on the CPU, for the dense engine and the paged engine (whole-prompt,
     chunked, and two pods behind the router), paged == dense;
  5. the dense path: llama3-8b at full width and full depth (bf16, seeded
     random weights) serving 8 requests through ``ServingEngine``, with
     the kernels' launch counts checked per forward; then a profiler trace
     of a few decode steps (device time per kernel, the device's idle share);
  5c. the paged path: the same weights through ``PagedServingEngine``,
     whole-prompt and with 128-token chunked prefill, each under
     ``traffic.run_open_loop`` (16 requests, Poisson arrivals, a Zipf pool
     of 8 synthetic prompts of 64-512 tokens), with launch counts checked
     per forward, the zero block checked and ``shutdown()`` passing; then a
     trace of four paged decode steps at batch 8;
  6. kernel times (CUDA events) beside the plain version, the one PyTorch
     call that computes the same function, and the card's bound.
The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# operations/s by type (bf16 on the tensor cores, f32 on the CUDA cores)
HBM_BYTES_S = 3.35e12
CUDA_LIBS = ("matmul", "flash_attention", "paged_attention")
# open-loop arrival rate of the paged serve phase (requests / second)
PAGED_RATE = 1.5
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}


def _ms_bound(nbytes: float, nops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, nops / PEAK_OPS_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the device-side name of each port kernel, as the profiler shows it
PORT_KERNELS = {"matmul": "matmul_kernel", "rmsnorm": "rms_kernel",
                "flash_attention": "flash_kernel",
                "paged_attention": "paged_kernel"}


def _reading(r: dict) -> str:
    """One element-wise check (``testing.kernel_checks``): the largest error,
    the same over the output's scale, and the largest share of its limit."""
    return (f"max_abs_err={r['max_abs_err']:.3e} rel_to_scale={r['rel_err']:.2e} "
            f"limit_use={r['limit_use']:.3f} (|err| <= {r['rtol']:.0e}|plain| + "
            f"{r['atol']:.0e}) {'ok' if r['ok'] else 'FAIL'}")


def _trace_decode(engine, steps: int) -> dict:
    """Device time of ``steps`` decode steps from a torch.profiler trace of
    the card's activity only (no host-op recording): time per kernel family,
    and the busy time, the union of the kernels' intervals.  The profiler
    still slows the host's launches, so twice as many steps are first timed
    without it; the idle share is read against their mean.  Times are per
    step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.testing.timing import now

    torch.cuda.synchronize()
    t0 = now()
    for _ in range(2 * steps):
        engine.step()
    plain_us = 1e6 * (now() - t0) / (2 * steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            engine.step()                # ends on a host read of the tokens
        wall_us = 1e6 * (now() - t0) / steps
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy, end = 0.0, -1.0
    by = {}
    for e in evs:
        s, f = e.time_range.start, e.time_range.end
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
        fam = next((f"{k} (port)" for k, tag in PORT_KERNELS.items()
                    if tag in e.name), e.name)
        n, t = by.get(fam, (0, 0.0))
        by[fam] = (n + 1 / steps, t + (f - s) / steps)
    return {"events": len(evs), "wall_us": wall_us, "plain_us": plain_us,
            "busy_us": busy / steps,
            "by": sorted(by.items(), key=lambda kv: -kv[1][1])}


def _check_pool(engine) -> None:
    """Every block back, the prefix registry empty (``shutdown``), and the
    zero block still zero in every layer."""
    from repro_torch.params import tree_leaves

    engine.shutdown()
    for leaf in tree_leaves(engine.pool):
        if bool(leaf[:, 0].any()):
            raise AssertionError("the zero block was written")


def _print_trace(tr: dict, steps: int, batch: int) -> None:
    if not tr["events"]:
        print("[trace] the profiler recorded no device activity: device time "
              "per kernel and idle share not measured")
        return
    print(f"[trace] {steps} decode steps at batch {batch}: "
          f"{tr['plain_us'] / 1e3:.2f} ms/step host clock over {2 * steps} "
          f"unprofiled steps, {tr['wall_us'] / 1e3:.2f} ms/step under the "
          f"profiler; device busy {tr['busy_us'] / 1e3:.2f} ms/step; idle "
          f"share {1 - tr['busy_us'] / tr['plain_us']:.3f} of the unprofiled "
          f"steps ({1 - tr['busy_us'] / tr['wall_us']:.3f} of the profiled)")
    port = [kv for kv in tr["by"] if kv[0].endswith("(port)")]
    other = [kv for kv in tr["by"] if not kv[0].endswith("(port)")]
    rest = (sum(n for _, (n, _) in other[6:]), sum(t for _, (_, t) in other[6:]))
    for fam, (n, t) in port + other[:6] + [
            (f"{len(other[6:])} other kernels", rest)]:
        print(f"[trace]   {t / 1e3:8.3f} ms/step  {n:6.1f} launches/step  "
              f"{fam[:90]}")


def _smoke_paged(scfg, cpu_params, gpu_params, dev) -> None:
    """The smoke model through the paged engine on the card and on the CPU,
    whole-prompt, chunked (chunk 16 over 8-token blocks) and as two pods
    behind the router, on a prompt set with duplicates (so blocks are
    shared and copied on write): every greedy stream equals the CPU's and
    the card's dense engine's."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.serve import (PagedServeConfig, PagedServingEngine,
                                   PrefixRouter, Request, ServeConfig,
                                   ServingEngine)

    rng = np.random.default_rng(0)
    base = [rng.integers(1, scfg.vocab_size, int(rng.integers(5, 20)))
            for _ in range(4)]
    prompts = [base[0], base[0].copy(), base[1], base[1].copy(), base[2],
               base[3]]

    def drive(front) -> dict:
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            front.submit(r)
        front.run()
        return {r.rid: list(r.out) for r in reqs}

    models = {"cpu": lm.Model(scfg, cpu_params), "cuda": lm.Model(scfg, gpu_params)}
    dense = drive(ServingEngine(models["cuda"], ServeConfig(max_batch=4, max_seq=64),
                                device=dev))
    for mode, chunk, pods in (("whole-prompt", 0, 1), ("chunked", 16, 1),
                              ("2-pod router", 0, 2)):
        got, counts = {}, {}
        for where in ("cpu", "cuda"):
            engines = [PagedServingEngine(
                models[where], PagedServeConfig(max_batch=4, max_seq=64,
                                                block_tokens=8, n_blocks=32,
                                                chunk=chunk),
                device=dev if where == "cuda" else "cpu") for _ in range(pods)]
            got[where] = drive(engines[0] if pods == 1 else PrefixRouter(engines))
            counts[where] = [(e.alloc.shared_hits, e.cow_copies, e.prefill_chunks)
                             for e in engines]
            for e in engines:
                _check_pool(e)
        same = got["cpu"] == got["cuda"] and counts["cpu"] == counts["cuda"]
        print(f"[smoke] paged {mode}: 6 requests, card == CPU: {same}; == dense "
              f"engine on the card: {got['cuda'] == dense}; (shared_hits, "
              f"cow_copies, prefill_chunks) per pod {counts['cuda']}; zero "
              f"block zero and shutdown() clean on both")
        if not same or got["cuda"] != dense:
            raise AssertionError(f"paged smoke streams differ ({mode}): {got}, "
                                 f"dense {dense}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.serve import (PagedServeConfig, PagedServingEngine,
                                   Request, ServeConfig, ServingEngine, traffic)
    from repro_torch.testing import kernel_checks as kc
    from repro_torch.testing.timing import now

    # f32 products in full f32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[setup] allow_tf32 = False for matmul and cuDNN")

    # -- 1. device -----------------------------------------------------------
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.splitlines()[0])

    # -- 2. build ------------------------------------------------------------
    t0 = now()
    _build.build(CUDA_LIBS)                 # one nvcc each, all started together
    print(f"[build] {', '.join(f'{n}.cu' for n in CUDA_LIBS)} -> "
          f"{_build.BUILD_DIR} in {now() - t0:.1f}s")
    for lib in CUDA_LIBS:
        for line in _build.BUILD_LOGS.get(lib, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {lib}: {line.strip()}")
    t0 = now()
    x, g = kc.rmsnorm_inputs(4, kc.D_MODEL, torch.bfloat16)
    krms.rmsnorm(x, g, kc.EPS)
    torch.cuda.synchronize()
    print(f"[build] triton rmsnorm first launch (compile) in {now() - t0:.1f}s")

    # -- 3. kernels vs plain versions ------------------------------------------
    errs = {}
    failed = []
    for proj, (K, N) in kc.MATMUL_KN.items():
        for M in kc.MATMUL_M:
            for dt in (torch.bfloat16, torch.float32):
                r = kc.check_matmul(M, K, N, dt)
                errs[("matmul", M, K, N, dt)] = r["max_abs_err"]
                print(f"[check] matmul {proj:7s} M={M:<4d} K={K:<5d} N={N:<5d} "
                      f"{str(dt)[6:]:8s} {_reading(r)}")
                if not r["ok"]:
                    failed.append(("matmul", proj, M, dt))
    for R in kc.RMSNORM_R:
        for dt in (torch.bfloat16, torch.float32):
            r = kc.check_rmsnorm(R, kc.D_MODEL, dt)
            errs[("rmsnorm", R, dt)] = r["max_abs_err"]
            print(f"[check] rmsnorm R={R:<4d} D={kc.D_MODEL} {str(dt)[6:]:8s} "
                  f"{_reading(r)}")
            if not r["ok"]:
                failed.append(("rmsnorm", R, dt))
    for dt in (torch.bfloat16, torch.float32):
        r = kc.check_paged_attention(dt)
        errs[("paged_attention", dt)] = r["max_abs_err"]
        print(f"[check] paged_attention B={len(kc.PAGED_LENS)} Hkv={kc.HKV} "
              f"G={kc.HQ // kc.HKV} D={kc.HEAD_DIM} bt={kc.PAGED_BT} lens="
              f"{list(kc.PAGED_LENS)} {str(dt)[6:]:8s} {_reading(r)}")
        if not r["ok"]:
            failed.append(("paged_attention", dt))
        for S, window in [(S, None) for S in kc.FLASH_S] + [kc.FLASH_WINDOW]:
            r = kc.check_flash_attention(S, dt, window)
            errs[("flash_attention", S, window, dt)] = r["max_abs_err"]
            print(f"[check] flash_attention B=1 Hq={kc.HQ} Hkv={kc.HKV} "
                  f"D={kc.HEAD_DIM} S={S:<4d} causal window={window} "
                  f"{str(dt)[6:]:8s} {_reading(r)}")
            if not r["ok"]:
                failed.append(("flash_attention", S, window, dt))
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")

    # -- 4. smoke model: kernel path on the card vs plain path on the CPU ------
    # f32 throughout; the paths differ only in f32 summation order, which
    # moves logits of order 1 by ~1e-6 per layer, so 1e-4 absolute
    scfg = get_smoke_config("llama3-8b")
    cpu_params = init_params(lm.model_defs(scfg),
                             torch.Generator().manual_seed(0), "cpu")
    gpu_params = tree_map(lambda t: t.to(dev), cpu_params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, scfg.vocab_size, (2, 21)))
    c_cpu, l_cpu = lm.prefill(cpu_params, toks, scfg, 64)
    c_gpu, l_gpu = lm.prefill(gpu_params, toks.to(dev), scfg, 64)
    worst = (l_gpu.cpu() - l_cpu).abs().max().item()
    for step in range(8):
        nxt = torch.argmax(l_cpu[:, -1], dim=-1, keepdim=True)
        pos = torch.tensor([21 + step, 21 + step])
        l_cpu, c_cpu = lm.decode_step(cpu_params, nxt, c_cpu, pos, scfg)
        l_gpu, c_gpu = lm.decode_step(gpu_params, nxt.to(dev), c_gpu, pos.to(dev),
                                      scfg)
        worst = max(worst, (l_gpu.cpu() - l_cpu).abs().max().item())
    print(f"[smoke] llama3-8b-smoke f32 prefill+8 decode logits, card vs CPU: "
          f"max_abs_err={worst:.3e} (tol 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"smoke logits differ by {worst}")
    streams = {}
    for where, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = ServingEngine(lm.Model(scfg, params),
                            ServeConfig(max_batch=2, max_seq=64), device=where)
        prng = np.random.default_rng(1)
        for rid in range(5):
            plen = int(prng.integers(4, 24))
            eng.submit(Request(rid=rid, max_new_tokens=12,
                               prompt=prng.integers(1, scfg.vocab_size, plen)))
        streams[where] = {r.rid: r.out for r in eng.run()}
    print(f"[smoke] greedy streams, 5 requests through 2 slots: card == CPU: "
          f"{streams['cpu'] == streams['cuda']}")
    if streams["cpu"] != streams["cuda"] or len(streams["cpu"]) != 5:
        raise AssertionError(f"smoke streams differ: {streams}")
    _smoke_paged(scfg, cpu_params, gpu_params, dev)

    # -- 5. main path: llama3-8b at full width, full depth --------------------
    cfg = get_config("llama3-8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = now()
    params = init_params(lm.model_defs(cfg), torch.Generator(dev).manual_seed(0),
                         dev)
    torch.cuda.synchronize()
    model = lm.Model(cfg, params)
    del params
    n_bytes = sum(t.numel() * t.element_size()
                  for t in model.state_dict().values())
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers of {cfg.n_layers} "
          f"(full depth), d_model {cfg.d_model}, {str(cfg.dtype)[6:]}, "
          f"{n_bytes / 1e9:.2f} GB of weights, drawn in {now() - t0:.1f}s")
    engine = ServingEngine(model, ServeConfig(max_batch=4, max_seq=512),
                           device=dev)
    prng = np.random.default_rng(0)
    plens = [int(n) for n in prng.integers(32, 257, 8)]
    prompts = [prng.integers(1, cfg.vocab_size, n) for n in plens]
    ops.reset_launches()
    torch.cuda.synchronize()
    t_start = now()
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, max_new_tokens=16, prompt=prompt))
    done = list(engine.run())
    wall = now() - t_start
    launches = dict(ops.LAUNCHES)
    # the engine's own spans: prefills and decode steps, each ending on a
    # host read of tokens; TTFT from submit to the first token's read
    tm = engine.timing
    n_prefill, n_decode = tm["prefills"], tm["decode_steps"]
    prefill_s, decode_s = tm["prefill_s"], tm["decode_s"]
    ttft = [r.t_first - r.t_submit for r in done]
    forwards = n_prefill + n_decode
    L = cfg.n_layers
    # per forward: 7 projections a layer, 2 norms a layer and the final
    # norm; whole-prompt attention once a layer per prefill (dense decode
    # attention is plain torch)
    want_launches = {"matmul": 7 * L * forwards, "rmsnorm": (2 * L + 1) * forwards,
                     "flash_attention": L * n_prefill, "paged_attention": 0}
    prompt_toks = sum(plens)
    decode_toks = sum(len(r.out) - 1 for r in done)
    print(f"[serve] {len(done)} of 8 requests finished, prompts {plens}, "
          f"{sum(len(r.out) for r in done)} tokens generated, "
          f"{n_prefill} prefills + {n_decode} decode steps in {wall:.2f}s")
    print(f"[serve] prefill {prompt_toks / prefill_s:.1f} tok/s "
          f"({prompt_toks} tokens in {prefill_s:.3f}s); decode "
          f"{decode_toks / decode_s:.1f} tok/s ({decode_toks} tokens in "
          f"{n_decode} steps, {1e3 * decode_s / n_decode:.2f} ms/step); "
          f"p50 TTFT {1e3 * float(np.median(ttft)):.1f} ms "
          f"(all 8 submitted at once, 4 slots)")
    print(f"[serve] launches {launches} (expected {want_launches}); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(done) != 8 or any(not r.out for r in done):
        raise AssertionError("not every request finished")
    if any(t >= cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    if launches != want_launches:
        raise AssertionError(f"dense path launches {launches} over {n_prefill} "
                             f"prefills + {n_decode} decode steps, expected "
                             f"{want_launches}")
    path_launches = {"dense": launches}

    # -- 5b. where a decode step's device time goes --------------------------
    # four fresh requests fill the 4 slots; the first step admits them, the
    # timed and traced steps are pure decode at batch 4
    n_trace = 4
    for rid, prompt in enumerate(prompts[:4]):
        engine.submit(Request(rid=100 + rid, max_new_tokens=3 * n_trace + 4,
                              prompt=prompt))
    engine.step()
    _print_trace(_trace_decode(engine, n_trace), n_trace, 4)
    engine.run()
    if not all(r.done for r in engine.finished):
        raise AssertionError("a traced request did not finish")
    _, logits = lm.prefill(engine.params,
                           torch.as_tensor(done[0].prompt, device=dev)[None],
                           cfg, 512)
    if logits.shape != (1, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"bad logits {logits.shape}")
    del engine, logits
    torch.cuda.empty_cache()

    # -- 5c. the paged path: llama3-8b at full width, full depth --------------
    # the same weights; a 513-block pool (block 0 the zero block) of 16-token
    # blocks, 8 slots of up to 1024 tokens; open-loop traffic over a Zipf pool
    # of 8 synthetic prompts at the full vocabulary
    lc = traffic.LoadConfig(n_requests=16, rate_rps=PAGED_RATE, zipf_a=1.1,
                            pool_size=8, min_prompt=64, max_prompt=512,
                            max_new=32, vocab_size=cfg.vocab_size, seed=0)
    pool_prompts = traffic.prompt_pool(lc)
    print(f"[paged] open loop: {lc.n_requests} requests at {lc.rate_rps} req/s "
          f"(Poisson), Zipf({lc.zipf_a}) over {lc.pool_size} prompts of "
          f"{[len(p) for p in pool_prompts]} tokens, {lc.max_new} new tokens "
          f"each; max_batch 8, max_seq 1024, block_tokens 16, n_blocks 512")
    paged_case = None
    for tag, chunk in (("paged", 0), ("paged_chunked", 128)):
        peng = PagedServingEngine(model, PagedServeConfig(
            max_batch=8, max_seq=1024, block_tokens=16, n_blocks=512,
            chunk=chunk), device=dev)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        m = traffic.run_open_loop(peng, lc)
        got = dict(ops.LAUNCHES)
        tm = peng.timing
        n_pf, n_ch, n_dec = tm["prefills"], tm["chunks"], tm["decode_steps"]
        fwd = n_pf + n_ch + n_dec
        want = {"matmul": 7 * L * fwd, "rmsnorm": (2 * L + 1) * fwd,
                "flash_attention": L * n_pf, "paged_attention": L * (n_ch + n_dec)}
        done_p = peng.finished
        dec_toks = sum(len(r.out) - 1 for r in done_p)
        print(f"[paged] {tag}: {m['completed']} of {lc.n_requests} completed in "
              f"{m['wall_s']:.2f}s; TTFT p50 {m['ttft_p50_ms']:.1f} ms, p99 "
              f"{m['ttft_p99_ms']:.1f} ms; {m['decode_tok_s']:.1f} tok/s "
              f"generated over the run; decode {dec_toks / tm['decode_s']:.1f} "
              f"tok/s, {1e3 * tm['decode_s'] / n_dec:.2f} ms/step over {n_dec} "
              f"steps; occupancy {m['occupancy']}, max concurrent "
              f"{m['max_concurrent']}")
        print(f"[paged] {tag}: {n_pf} whole prefills ({tm['prefill_s']:.3f}s), "
              f"{n_ch} chunks ({tm['chunk_s']:.3f}s); shared_hits "
              f"{peng.alloc.shared_hits}, cow_copies {peng.cow_copies}, "
              f"prefill_chunks {peng.prefill_chunks}; peak resident KV "
              f"{peng.kv_bytes_resident_peak()} bytes ({peng.alloc.peak_allocated} "
              f"blocks); max_memory_allocated {torch.cuda.max_memory_allocated()} "
              f"bytes (since this engine's run began)")
        print(f"[paged] {tag}: launches {got} (expected {want})")
        if m["completed"] != lc.n_requests or len(done_p) != lc.n_requests:
            raise AssertionError(f"{tag}: not every request finished")
        if any(not r.out or max(r.out) >= cfg.vocab_size for r in done_p):
            raise AssertionError(f"{tag}: a token outside the vocabulary")
        if got != want:
            raise AssertionError(f"{tag}: launches {got}, expected {want}")
        if chunk and not n_ch or not chunk and (n_ch or not peng.alloc.shared_hits):
            raise AssertionError(f"{tag}: chunks {n_ch}, shared_hits "
                                 f"{peng.alloc.shared_hits}")
        _check_pool(peng)
        path_launches[tag] = got
        if not chunk:
            # -- 5d. where a paged decode step's device time goes ------------
            # eight pool prompts fill the 8 slots; the first step admits them
            for rid, prompt in enumerate(pool_prompts):
                peng.submit(Request(rid=200 + rid, prompt=prompt,
                                    max_new_tokens=3 * n_trace + 4))
            peng.step()
            _print_trace(_trace_decode(peng, n_trace), n_trace, 8)
            # the next step's attention inputs, kept for phase 6: every
            # layer's pool view, the tables and the lens
            paged_case = {
                "views": [(lv["k"][i].permute(2, 0, 1, 3), lv["v"][i].permute(2, 0, 1, 3))
                          for lv in (peng.pool[k]["s0_attn"] for k in peng.pool)
                          for i in range(cfg.n_periods)],
                "tables": torch.from_numpy(peng.tables.copy()).to(dev),
                "lens": torch.from_numpy(peng.slot_pos + 1).to(dev)}
            peng.run()
            _check_pool(peng)
        del peng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()

    # -- 6. kernel times ---------------------------------------------------------
    def time_ms(fn, iters: int) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    rows = {}
    for proj, (K, N) in kc.MATMUL_KN.items():
        for M in kc.MATMUL_M:
            for dt in (torch.bfloat16, torch.float32):
                a, b = kc.matmul_inputs(M, K, N, dt)
                # cycle through copies of the weight totalling > 2x the 50 MB
                # L2, so each launch finds it cold, as the model's layers do
                nb = max(1, min(8, math.ceil(100e6 / (b.numel() * b.element_size()))))
                bs = [b.clone() for _ in range(nb)]
                it = [0]

                def pick():
                    it[0] += 1
                    return bs[it[0] % nb]
                iters = 20 if M * K * N > 1e10 else 50
                t_k = time_ms(lambda: kmm.matmul(a, pick()), iters)
                t_p = time_ms(lambda: ref.matmul(a, pick()), iters)
                t_l = time_ms(lambda: torch.matmul(a, pick()), iters)
                kind = "bf16" if dt == torch.bfloat16 else "f32"
                isz = a.element_size()
                bound, by = _ms_bound((M * K + K * N + M * N) * isz,
                                      2.0 * M * N * K, kind)
                rows[("matmul", M, K, N, dt)] = (t_k, t_p, t_l, bound, by)
                print(f"[time] matmul {proj:7s} M={M:<4d} K={K:<5d} N={N:<5d} "
                      f"{kind:4s} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
                      f"torch.matmul {t_l:.4f} ms  bound {bound:.4f} ms ({by})")
                del a, b, bs
    for R in kc.RMSNORM_R:
        for dt in (torch.bfloat16, torch.float32):
            x, g = kc.rmsnorm_inputs(R, kc.D_MODEL, dt)
            g_lib = g.to(dt)
            D = kc.D_MODEL
            t_k = time_ms(lambda: krms.rmsnorm(x, g, kc.EPS), 200)
            t_p = time_ms(lambda: ref.rmsnorm(x, g, kc.EPS), 200)
            t_l = time_ms(lambda: torch.nn.functional.rms_norm(
                x, (D,), g_lib, kc.EPS), 200)
            kind = "bf16" if dt == torch.bfloat16 else "f32"
            bound, by = _ms_bound(2 * R * D * x.element_size() + 4 * D,
                                  4.0 * R * D, "f32")
            rows[("rmsnorm", R, dt)] = (t_k, t_p, t_l, bound, by)
            print(f"[time] rmsnorm R={R:<4d} D={D} {kind:4s} kernel {t_k:.4f} ms  "
                  f"plain {t_p:.4f} ms  F.rms_norm {t_l:.4f} ms  "
                  f"bound {bound:.5f} ms ({by})")

    # flash attention at whole-prompt lengths (bf16, the model's dtype; f32
    # at the longest), beside SDPA on the same causal GQA function
    Hq, Hkv, D = kc.HQ, kc.HKV, kc.HEAD_DIM
    for S, dt in ((37, torch.bfloat16), (256, torch.bfloat16),
                  (512, torch.bfloat16), (512, torch.float32)):
        q, k, v = kc.flash_inputs(S, dt)
        iters = 50 if S > 100 else 200
        t_k = time_ms(lambda: kfa.flash_attention(q, k, v, causal=True), iters)
        t_p = time_ms(lambda: ref.attention(q, k, v, causal=True), iters)
        t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        # q and out once, k and v once; 4 D operations per visible (q, k) pair
        bound, by = _ms_bound(q.element_size() * S * D * (2 * Hq + 2 * Hkv),
                              4.0 * D * Hq * S * (S + 1) / 2, kind)
        rows[("flash_attention", S, dt)] = (t_k, t_p, t_l, bound, by)
        print(f"[time] flash_attention B=1 Hq={Hq} Hkv={Hkv} D={D} S={S:<4d} "
              f"causal {kind:4s} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
              f"SDPA {t_l:.4f} ms  bound {bound:.5f} ms ({by})")

    # paged attention at the traced batch-8 decode step's inputs, cycling
    # over the 32 layers' pools so each launch finds its K/V cold in L2, as
    # a decode step does; no one PyTorch call computes it
    views, tables, lens = (paged_case[k] for k in ("views", "tables", "lens"))
    B, nb = tables.shape
    G = Hq // Hkv
    q = torch.randn((B, Hkv, G, D), generator=torch.Generator(dev).manual_seed(0),
                    device=dev).to(torch.bfloat16)
    r = kc.compare(kpa.paged_attention(q, *views[0], tables, lens),
                    ref.paged_attention(q, *views[0], tables, lens),
                    kc.ATTN_TOL[torch.bfloat16])
    it = [0]

    def pick():
        it[0] += 1
        return views[it[0] % len(views)]
    t_k = time_ms(lambda: kpa.paged_attention(q, *pick(), tables, lens), 128)
    t_p = time_ms(lambda: ref.paged_attention(q, *pick(), tables, lens), 32)
    n_tok = int(lens.sum())
    bound, by = _ms_bound(n_tok * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                          + tables.numel() * 4 + B * 4,
                          4.0 * n_tok * Hkv * G * D, "bf16")
    rows[("paged_attention",)] = (t_k, t_p, None, bound, by)
    errs[("paged_attention",)] = r["max_abs_err"]
    print(f"[time] paged_attention B={B} Hkv={Hkv} G={G} D={D} bt=16 lens="
          f"{lens.tolist()} bf16 kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
          f"(no one-call PyTorch counterpart)  bound {bound:.5f} ms ({by}); "
          f"against plain: {_reading(r)}")
    if not r["ok"]:
        raise AssertionError("paged_attention disagrees at the decode inputs")

    # the decode-step shapes, where serving spends most of its time, and the
    # longest whole-prompt prefill; launches summed over the three main paths
    total = {k: sum(pl[k] for pl in path_launches.values())
             for k in ops.LAUNCHES}
    kernels = []
    for kname, key, err_key, route, source, replaces, shape in (
            ("matmul", ("matmul", 4, 4096, 14336, torch.bfloat16), None, "cuda",
             "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:84", "M=4,K=4096,N=14336,bf16"),
            ("rmsnorm", ("rmsnorm", 4, torch.bfloat16), None, "triton",
             "src/repro_torch/kernels/rmsnorm.py",
             "src/repro/kernels/rmsnorm.py:44", "R=4,D=4096,bf16"),
            ("flash_attention", ("flash_attention", 512, torch.bfloat16),
             ("flash_attention", 512, None, torch.bfloat16), "cuda",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:118",
             "B=1,Hq=32,Hkv=8,S=512,D=128,causal,bf16"),
            ("paged_attention", ("paged_attention",), None, "cuda",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:104",
             f"B={B},Hkv=8,G=4,D=128,bt=16,tokens={n_tok},bf16")):
        t_k, t_p, t_l, bound, by = rows[key]
        kernels.append({"name": kname, "route": route, "source": source,
                        "replaces": replaces, "launches": total[kname],
                        "launches_by_path": {p: pl[kname] for p, pl
                                             in path_launches.items()},
                        "max_abs_err": errs[err_key or key], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                        "library_ms": t_l, "shape": shape})
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel never launched on the main paths: {total}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
