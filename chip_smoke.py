#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA matmul library (nvcc, sm_90a) and the Triton rmsnorm;
  3. each kernel against its plain PyTorch version on the card, at the
     llama3-8b serving shapes;
  4. the llama3-8b smoke model (f32, seeded weights): logits and greedy
     token streams of the kernel path on the card against the plain path
     on the CPU;
  5. the main path: llama3-8b at full width and full depth (bf16, seeded
     random weights) serving 8 requests through ``ServingEngine``, with
     the kernels' launch counts checked per forward; then a profiler trace
     of a few decode steps (device time per kernel, the device's idle share);
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
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}


def _ms_bound(nbytes: float, nops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, nops / PEAK_OPS_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    still slows the host's launches, so the same number of steps is first
    timed without it; the idle share is read against that time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.testing.timing import now

    torch.cuda.synchronize()
    t0 = now()
    for _ in range(steps):
        engine.step()
    plain_us = 1e6 * (now() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            engine.step()                # ends on a host read of the tokens
        wall_us = 1e6 * (now() - t0)
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy, end = 0.0, -1.0
    by = {}
    for e in evs:
        s, f = e.time_range.start, e.time_range.end
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
        fam = ("matmul (port)" if "matmul_kernel" in e.name else
               "rmsnorm (port)" if "rms_kernel" in e.name else e.name)
        n, t = by.get(fam, (0, 0.0))
        by[fam] = (n + 1, t + (f - s))
    return {"events": len(evs), "wall_us": wall_us, "plain_us": plain_us,
            "busy_us": busy,
            "by": sorted(by.items(), key=lambda kv: -kv[1][1])}


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
    from repro_torch.serve import Request, ServeConfig, ServingEngine
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
    _build.library("matmul")
    print(f"[build] matmul.cu -> {_build.BUILD_DIR} in {now() - t0:.1f}s")
    for line in _build.BUILD_LOGS.get("matmul", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
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
    per_fwd = {"matmul": 7 * cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1}
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
    seen = {k: v / forwards for k, v in launches.items()}
    print(f"[serve] launches {launches}, per forward {seen} "
          f"(expected {per_fwd}); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(done) != 8 or any(not r.out for r in done):
        raise AssertionError("not every request finished")
    if any(t >= cfg.vocab_size for r in done for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    for k, n in per_fwd.items():
        if launches[k] != n * forwards:
            raise AssertionError(f"{k}: {launches[k]} launches for {forwards} "
                                 f"forwards, expected {n} each")

    # -- 5b. where a decode step's device time goes --------------------------
    # four fresh requests fill the 4 slots; the first step admits them, the
    # timed and traced steps are pure decode at batch 4
    n_trace = 4
    for rid, prompt in enumerate(prompts[:4]):
        engine.submit(Request(rid=100 + rid, max_new_tokens=2 * n_trace + 4,
                              prompt=prompt))
    engine.step()
    tr = _trace_decode(engine, n_trace)
    if tr["events"]:
        print(f"[trace] {n_trace} decode steps at batch 4: "
              f"{tr['plain_us'] / 1e3 / n_trace:.2f} ms/step host clock, "
              f"{tr['wall_us'] / 1e3 / n_trace:.2f} ms/step under the profiler; "
              f"device busy {tr['busy_us'] / 1e3 / n_trace:.2f} ms/step; idle "
              f"share {1 - tr['busy_us'] / tr['plain_us']:.3f} of the unprofiled "
              f"steps ({1 - tr['busy_us'] / tr['wall_us']:.3f} of the profiled)")
        port = [kv for kv in tr["by"] if kv[0].endswith("(port)")]
        other = [kv for kv in tr["by"] if not kv[0].endswith("(port)")]
        rest = (sum(n for _, (n, _) in other[6:]),
                sum(t for _, (_, t) in other[6:]))
        for fam, (n, t) in port + other[:6] + [
                (f"{len(other[6:])} other kernels", rest)]:
            print(f"[trace]   {t / 1e3 / n_trace:8.3f} ms/step  "
                  f"{n / n_trace:6.1f} launches/step  {fam[:90]}")
    else:
        print("[trace] the profiler recorded no device activity: device time "
              "per kernel and idle share not measured")
    engine.run()
    if not all(r.done for r in engine.finished):
        raise AssertionError("a traced request did not finish")
    _, logits = lm.prefill(engine.params,
                           torch.as_tensor(done[0].prompt, device=dev)[None],
                           cfg, 512)
    if logits.shape != (1, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"bad logits {logits.shape}")
    del engine, model, logits
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

    # the decode-step shapes, where serving spends most of its time
    mm_key = ("matmul", 4, 4096, 14336, torch.bfloat16)
    rms_key = ("rmsnorm", 4, torch.bfloat16)
    kernels = []
    for kname, key, route, source, replaces, shape in (
            ("matmul", mm_key, "cuda", "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul.py:84", "M=4,K=4096,N=14336,bf16"),
            ("rmsnorm", rms_key, "triton", "src/repro_torch/kernels/rmsnorm.py",
             "src/repro/kernels/rmsnorm.py:44", "R=4,D=4096,bf16")):
        t_k, t_p, t_l, bound, by = rows[key]
        kernels.append({"name": kname, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": errs[key], "ms": t_k, "plain_ms": t_p,
                        "bound_ms": bound, "bound_by": by, "library_ms": t_l,
                        "shape": shape})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
