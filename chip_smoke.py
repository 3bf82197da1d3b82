#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA libraries (matmul, flash_attention, paged_attention,
     reduction, stencil; one nvcc each, all at once, sm_90a) and the Triton
     rmsnorm; ptxas's registers and spills (for flash_attention by kernel,
     with any wgmma serialisation notice);
  3. each kernel against its plain PyTorch version on the card, element by
     element, at the llama3-8b serving shapes, in bf16 and f32 (the matmul
     at every main-path M, 1 to 512, and at ragged shapes; flash attention
     at every whole-prompt length of the paths, ragged ones, B = 2,
     windows across tile edges, and every head dim causal and not; each
     line naming the kernel variant it took);
  3b. the paper's Table I kernels (dotprod, expv, softmax_rows, jacobi2d,
     fconv2d) against their plain versions at the table1-paper and
     table1-card shapes and at ragged ones (softmax also on masked rows),
     in f32 and bf16; dotprod and dotprod_hier against an f64 sum, with
     dots that round to bf16 as controls that must fail the same check;
     expv on every f32 bit pattern (2**32, in chunks of 2**28), every bf16
     one and the round-half edges of its range reduction, the bits that
     differ counted (``kernel_checks.sweep_expv``);
  4. the llama3-8b smoke model (f32, seeded weights): logits and greedy
     token streams of the kernel path on the card against the plain path
     on the CPU, for the dense engine and the paged engine (whole-prompt,
     chunked, and two pods behind the router), paged == dense;
  5. the dense path: llama3-8b at full width and full depth (bf16, seeded
     random weights) serving 8 requests through ``ServingEngine``, with
     the kernels' launch counts checked per forward; then profiler traces
     of a few decode steps and of two whole-prompt prefills (device time per
     kernel, the device's idle share);
  5c. the paged path: the same weights through ``PagedServingEngine``,
     whole-prompt and with 128-token chunked prefill, each under
     ``traffic.run_open_loop`` (16 requests, Poisson arrivals, a Zipf pool
     of 8 synthetic prompts of 64-512 tokens), with launch counts checked
     per forward, the zero block checked and ``shutdown()`` passing; then a
     trace of four paged decode steps at batch 8;
  5e. the Table I path: each Table I workload once through ``ops`` at both
     configurations (f32), outputs held against the plain versions, launch
     counts checked;
  6. kernel times (CUDA events) beside the plain version, the one PyTorch
     call that computes the same function, and the card's bound (the matmul
     at every main-path M in both dtypes, and each matmul variant's host
     cost a call at K = N = 64; flash attention at S = 37, 223, 445 and 512
     with the device's ms a call beside SDPA's from one trace, and each
     variant's host cost a call), the Table I kernels at both
     configurations (at table1-paper also their device time and the
     library call's from profiler traces, and dotprod's and expv's host
     cost a call in turns with torch.dot and torch.exp).
The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.  Without a card,
or without the repo's ``src/repro_torch`` beside it, it exits non-zero
before any phase (2 and 1).
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
CUDA_LIBS = ("matmul", "flash_attention", "paged_attention", "reduction",
             "stencil")
# open-loop arrival rate of the paged serve phase (requests / second)
PAGED_RATE = 1.5
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}


def _ms_bound(nbytes: float, nops: float, kind: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, nops / PEAK_OPS_S[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the device-side name of each port kernel, as the profiler shows it (the
# matmul and flash attention by variant: kernels.matmul.variant,
# kernels.flash_attention.variant)
PORT_KERNELS = {"matmul decode": "matmul_decode_kernel",
                "matmul wgmma": "matmul_wgmma_kernel",
                "matmul simt": "matmul_kernel", "rmsnorm": "rms_kernel",
                "flash_attention wgmma": "flash_wgmma_kernel",
                "flash_attention simt": "flash_kernel",
                "paged_attention": "paged_kernel"}


def _reading(r: dict) -> str:
    """One element-wise check (``testing.kernel_checks``): the largest error,
    the same over the output's scale, and the largest share of its limit."""
    return (f"max_abs_err={r['max_abs_err']:.3e} rel_to_scale={r['rel_err']:.2e} "
            f"limit_use={r['limit_use']:.3f} (|err| <= {r['rtol']:.0e}|plain| + "
            f"{r['atol']:.0e}) {'ok' if r['ok'] else 'FAIL'}")


def _trace(step, steps: int) -> dict:
    """Device time of ``steps`` calls of ``step`` (a decode step, or a
    prefill that ends on a host read) from a torch.profiler trace of the
    card's activity only (no host-op recording): time per kernel family,
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
        step()
    plain_us = 1e6 * (now() - t0) / (2 * steps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = now()
        for _ in range(steps):
            step()                       # ends on a host read
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


def _ptxas_summary(log: str) -> list:
    """nvcc's ``-Xptxas -v`` lines, one a kernel: its name (template
    arguments kept: dtype, head dim, vec or scalar loads), registers,
    spills, static shared memory, and any ptxas performance notice (C75xx)
    beside it."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?"
                      r"_ZN\w*?(\d+)([a-z_]+kernel)I(\w+?)E+v", line)
        if m:
            args = (m.group(3).replace("13__nv_bfloat16", "bf16 ").replace("Li", "D=")
                    .replace("Lb1", "vec").replace("Lb0", "scalar"))
            if args.startswith("f"):
                args = "f32 " + args[1:]
            name = f"{m.group(2)}<{args.strip()}>"
        if name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.replace('ptxas info    :', '').strip()}")
        if "C75" in line:
            out.append(line.strip()[:160])
    return out


def _check_pool(engine) -> None:
    """Every block back, the prefix registry empty (``shutdown``), and the
    zero block still zero in every layer."""
    from repro_torch.params import tree_leaves

    engine.shutdown()
    for leaf in tree_leaves(engine.pool):
        if bool(leaf[:, 0].any()):
            raise AssertionError("the zero block was written")


def _print_trace(tr: dict, steps: int, what: str) -> None:
    if not tr["events"]:
        print("[trace] the profiler recorded no device activity: device time "
              "per kernel and idle share not measured")
        return
    print(f"[trace] {steps} {what}: "
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


def _table1_checks(kc) -> tuple[dict, list]:
    """Phase 3b: each Table I kernel against its plain version at both
    configurations' shapes and at the ragged ones, in bf16 and f32.  Returns
    the largest error of each f32 check at table1-card, and the failures."""
    import torch

    errs, failed = {}, []
    shapes = {k: [] for k in ("jacobi", "conv", "dot", "expv", "softmax", "hier",
                              *kc.RAGGED)}
    for cname, cfg in kc.TABLE1.items():
        shapes["jacobi"].append((cname, cfg["jacobi"]))
        shapes["conv"].append((cname, cfg["conv"]))
        shapes["dot"].append((cname, cfg["dot"]))
        shapes["expv"].append((cname, cfg["dot"]))
        shapes["softmax"] += [(cname, rw) for rw in cfg["softmax"]]
        shapes["hier"] += [(cname, (cfg["dot"], C, L, h)) for C, L in cfg["hier"]
                           for h in kc.HIERARCHIES]
    for k, cases in kc.RAGGED.items():
        shapes[k] += [("ragged", c) for c in cases]
    run = {"jacobi": lambda c, dt: kc.check_jacobi2d(*c, dt),
           "conv": lambda c, dt: kc.check_fconv2d(*c, dt),
           "dot": lambda c, dt: kc.check_dotprod(c, dt),
           "expv": lambda c, dt: kc.check_expv(c, dt),
           "softmax": lambda c, dt: kc.check_softmax_rows(*c, dt),
           "softmax_masked": lambda c, dt: kc.check_softmax_rows(*c, dt, masked=True),
           "hier": lambda c, dt: kc.check_dotprod_hier(*c, dt)}
    for k, cases in shapes.items():
        for cname, c in cases:
            for dt in (torch.bfloat16, torch.float32):
                r = run[k](c, dt)
                extra = (f" ulps={r['ulps']}" if k == "expv" else
                         " resident" if r.get("resident") else
                         " two-read" if k.startswith("softmax") else
                         f"; exact on +-1 inputs: {r['exact_on_signs']}; "
                         "controls' limit_use (must be > 1): " + ", ".join(
                             f"{w} {u:.1f}" for w, u in r["controls"].items())
                         if k in ("dot", "hier") else "")
                print(f"[table1] check {k:14s} {cname:12s} {str(c):32s} "
                      f"{str(dt)[6:]:8s} {_reading(r)}{extra}")
                if cname == "table1-card" and dt == torch.float32:
                    errs[(k, c)] = r["max_abs_err"]
                if not r["ok"]:
                    failed.append((k, cname, c, dt))
                torch.cuda.empty_cache()
    return errs, failed


def _table1_path(kc, ops, ref, dev) -> dict:
    """Phase 5e: the Table I workloads once each through ``ops`` at both
    configurations in f32, every output held against its plain version
    (whose calls launch nothing), the launches checked.  Returns them."""
    import torch

    ops.reset_launches()
    want = {k: 0 for k in ops.LAUNCHES}
    for cname, cfg in kc.TABLE1.items():
        (H, W), (ch, cw, f), n = cfg["jacobi"], cfg["conv"], cfg["dot"]
        x = kc.grid_inputs(H, W, torch.float32, dev, seed=1)
        got = ops.jacobi2d(x)
        checks = [("jacobi2d", kc.compare(got, ref.jacobi2d(x), kc.JACOBI_TOL))]
        xc, filt = kc.conv_inputs(ch, cw, f, torch.float32, dev, seed=1)
        checks.append(("fconv2d", kc.compare(ops.fconv2d(xc, filt),
                                             ref.fconv2d(xc, filt),
                                             (0.0, kc.conv_bound(xc, filt)))))
        del x, got, xc
        a, b = kc.vec_inputs(n, torch.float32, dev, seed=1)
        got = ops.dotprod(a, b)
        checks.append(("dotprod (f64 sum)",
                       kc.compare_dot(got, got, a, b, kc.dot_chain(n))))
        for what, r in kc.dot_controls(a, b, kc.dot_chain(n)).items():
            checks.append((f"dotprod's limit against a dot with {what} (must "
                           f"read above it)", {**r, "ok": not r["ok"]}))
        for C, L in cfg["hier"]:
            for h in kc.HIERARCHIES:
                got = ops.dotprod_hier(a, b, C=C, L=L, hierarchy=h)
                checks.append((f"dotprod_hier {C}x{L} {h} (f64 sum)",
                               kc.compare_dot(got, got, a, b,
                                              kc.hier_chain(n, C, L))))
                want["dotprod"] += 1
        del a, b
        x = kc.exp_inputs(n, torch.float32, dev, seed=1)
        checks.append(("expv", kc.compare_expv(ops.expv(x), ref.expv(x))))
        for R, Wd in cfg["softmax"]:
            x = kc.softmax_inputs(R, Wd, torch.float32, dev, seed=1)
            got = ops.softmax_rows(x)
            r = kc.compare(got, ref.softmax_rows(x), kc.SOFTMAX_TOL[torch.float32])
            row_sums = (got.double().sum(-1) - 1).abs().max().item()
            r["ok"] = r["ok"] and row_sums < 1e-4
            checks.append((f"softmax_rows ({R}, {Wd}) rows sum to 1 within "
                           f"{row_sums:.1e}", r))
            del x, got
        for k in ("dotprod", "expv", "jacobi2d", "fconv2d"):
            want[k] += 1
        want["softmax_rows"] += len(cfg["softmax"])
        for what, r in checks:
            print(f"[table1] path {cname:12s} {what}: {_reading(r)}")
            if not r["ok"]:
                raise AssertionError(f"Table I path, {cname}: {what} disagrees")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    got = dict(ops.LAUNCHES)
    print(f"[table1] path launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"Table I path launches {got}, expected {want}")
    return got


def _kernel_events(fn, calls: int) -> list:
    """The card's kernels in a torch.profiler trace of ``calls`` calls of
    ``fn`` (it may miss the first few)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _ms(evs) -> float:
    return sum(e.time_range.end - e.time_range.start for e in evs) / 1e3


def _device_ms(fn, tag: str, calls: int) -> tuple[float, int]:
    """The mean device time of the kernels named ``tag`` in a trace of
    ``calls`` calls of ``fn``, and how many of them the trace holds; (nan,
    0) if it holds none."""
    evs = [e for e in _kernel_events(fn, calls) if tag in e.name]
    return (_ms(evs) / len(evs), len(evs)) if evs else (float("nan"), 0)


def _device_split(fn, tag: str, calls: int) -> tuple[float, float]:
    """Device ms a call of the kernel named ``tag`` (one launch a call of
    ``fn``) and of every other kernel, from one trace of ``calls`` calls:
    both over the calls the trace holds, counted by the tagged kernel."""
    evs = _kernel_events(fn, calls)
    mine = [e for e in evs if tag in e.name]
    if not mine:
        return float("nan"), float("nan")
    return _ms(mine) / len(mine), (_ms(evs) - _ms(mine)) / len(mine)


def _device_per_call(fn, calls: int) -> float:
    """Device ms a call of ``fn``: all its kernels in a trace of ``calls``
    calls (``_device_ms`` with no name filter), summed, over the calls."""
    ms, n = _device_ms(fn, "", calls)
    return ms * n / calls if n else float("nan")


def _table1_times(kc, kred, kst, ref, time_ms, dev) -> dict:
    """Phase 6, Table I: kernel, plain, library (one PyTorch call of the same
    function; cuDNN without TF32 for the convolutions) and the card's bound
    at both configurations, f32.  Bound: each input read once, each output
    written once; operations per element as counted in each line.  At
    table1-paper, where every operand sits in L2, the kernel's own device
    time and the library call's from profiler traces too, to part the
    host's cost from the card's, and dotprod's and expv's host cost a call
    in turns with the library's."""
    import torch
    import torch.nn.functional as F

    rows = {}
    for cname, cfg in kc.TABLE1.items():
        card = cname == "table1-card"
        it_k, it_p = (20, 3) if card else (200, 50)

        def row(kname, shape, fk, fp, fl, nbytes, nops, lib, tag):
            t_k, t_p = time_ms(fk, it_k), time_ms(fp, it_p)
            t_l = time_ms(fl, it_k)
            bound, by = _ms_bound(nbytes, nops, "f32")
            if card:
                t_d, n_d, t_ld = float("nan"), 0, float("nan")
            else:
                t_d, n_d = _device_ms(fk, tag, 50)
                t_ld = _device_per_call(fl, 50)
            # the first shape of a kernel stands for it in the kernels line
            rows.setdefault((kname, cname),
                            (t_k, t_p, t_l, bound, by, shape, t_d, t_ld))
            device = "" if card else (f"; device: {tag} {t_d:.4f} ms (mean of "
                                      f"{n_d} in a trace of 50 calls), {lib} "
                                      f"{t_ld:.4f} ms a call")
            print(f"[time] {kname:12s} {cname:12s} {shape:34s} f32 kernel "
                  f"{t_k:.4f} ms  plain {t_p:.4f} ms  {lib} {t_l:.4f} ms  "
                  f"bound {bound:.3g} ms ({by}){device}")

        H, W = cfg["jacobi"]
        x = kc.grid_inputs(H, W, torch.float32, dev)
        cross = torch.tensor([[0, .25, 0], [.25, 0, .25], [0, .25, 0]],
                             device=dev)[None, None]
        # 3 adds and a multiply an element
        row("jacobi2d", f"({H}, {W})", lambda: kst.jacobi2d(x),
            lambda: ref.jacobi2d(x),
            lambda: F.conv2d(x[None, None], cross, padding=1),
            8 * H * W, 4 * H * W, "F.conv2d", "jacobi_kernel")
        del x
        ch, cw, f = cfg["conv"]
        x, filt = kc.conv_inputs(ch, cw, f, torch.float32, dev)
        oh, ow = ch - f + 1, cw - f + 1
        row("fconv2d", f"({ch}, {cw}) * {f}x{f} -> ({oh}, {ow})",
            lambda: kst.fconv2d(x, filt), lambda: ref.fconv2d(x, filt),
            lambda: F.conv2d(x[None, None], filt[None, None]),
            4 * (ch * cw + oh * ow + f * f), 2 * f * f * oh * ow, "F.conv2d",
            "conv_kernel")
        del x
        n = cfg["dot"]
        a, b = kc.vec_inputs(n, torch.float32, dev)
        row("dotprod", f"n={n}", lambda: kred.dotprod(a, b),
            lambda: ref.dotprod(a, b), lambda: torch.dot(a, b),
            8 * n + 4, 2 * n, "torch.dot", "dot_kernel")
        for C, L in cfg["hier"]:
            for h in kc.HIERARCHIES:
                row("dotprod_hier", f"n={n} {C}x{L} {h}",
                    lambda: kred.dotprod_hier(a, b, C=C, L=L, hierarchy=h),
                    lambda: ref.dotprod(a, b), lambda: torch.dot(a, b),
                    8 * n + 4, 2 * n, "torch.dot", "dot_kernel")
        del a, b
        x = kc.exp_inputs(n, torch.float32, dev)
        xc = x.clamp(-80, 80)
        # clip 2, multiply 1, round 1, 7 fused multiply-adds 14, exponent 2
        row("expv", f"n={n}", lambda: kred.expv(x), lambda: ref.expv(x),
            lambda: torch.exp(xc), 8 * n, 20 * n, "torch.exp", "expv_kernel")
        del x, xc
        for R, Wd in cfg["softmax"]:
            x = kc.softmax_inputs(R, Wd, torch.float32, dev)
            # max, subtract, exp, add, divide: ~5 an element
            row("softmax_rows", f"({R}, {Wd})", lambda: kred.softmax_rows(x),
                lambda: ref.softmax_rows(x), lambda: torch.softmax(x, -1),
                8 * R * Wd, 5 * R * Wd, "torch.softmax", "softmax_kernel")
            del x
        torch.cuda.empty_cache()
    # dotprod's and expv's host cost a call: back-to-back calls at
    # table1-paper, where the kernel takes a few us of device time, between
    # events, in turns with the library call (kernel, library, library,
    # kernel)
    n = kc.TABLE1["table1-paper"]["dot"]
    a, b = kc.vec_inputs(n, torch.float32, dev)
    x = kc.exp_inputs(n, torch.float32, dev)
    xc = x.clamp(-80, 80)
    for kname, fk, lib, fl in (
            ("dotprod", lambda: kred.dotprod(a, b), "torch.dot", lambda: torch.dot(a, b)),
            ("expv", lambda: kred.expv(x), "torch.exp", lambda: torch.exp(xc))):
        host = {"kernel": [], "library": []}
        for turn, fn in (("kernel", fk), ("library", fl), ("library", fl),
                         ("kernel", fk)):
            host[turn].append(1e3 * time_ms(fn, 500))
        rows[(kname, "host")] = host
        print(f"[time] {kname} host cost n={n} f32, us a call in turns: kernel "
              + " / ".join(f"{t:.1f}" for t in host["kernel"]) + f"; {lib} "
              + " / ".join(f"{t:.1f}" for t in host["library"]))
    return rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 2

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT / 'chip_smoke.py'}; "
              "run it from the root of a checkout of the repo", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import reduction as kred
    from repro_torch.kernels import stencil as kst
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
        if lib in ("flash_attention", "reduction"):     # each kernel by name
            for line in _ptxas_summary(_build.BUILD_LOGS.get(lib, "")):
                print(f"[build]   {lib}: {line}")
            continue
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
                      f"{str(dt)[6:]:8s} {kmm.variant(M, K, N, dt):6s} {_reading(r)}")
                if not r["ok"]:
                    failed.append(("matmul", proj, M, dt))
    for M, K, N, dt in kc.MATMUL_RAGGED:
        r = kc.check_matmul(M, K, N, dt)
        print(f"[check] matmul ragged  M={M:<4d} K={K:<5d} N={N:<5d} "
              f"{str(dt)[6:]:8s} {kmm.variant(M, K, N, dt):6s} {_reading(r)}")
        if not r["ok"]:
            failed.append(("matmul ragged", M, K, N, dt))
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
        for B, S, window in kc.FLASH_CASES:
            r = kc.check_flash_attention(S, dt, window, B=B)
            errs[("flash_attention", B, S, window, dt)] = r["max_abs_err"]
            print(f"[check] flash_attention B={B} Hq={kc.HQ} Hkv={kc.HKV} "
                  f"D={kc.HEAD_DIM} S={S:<4d} causal window={window} "
                  f"{str(dt)[6:]:8s} {r['variant']:5s} {_reading(r)}")
            if not r["ok"]:
                failed.append(("flash_attention", B, S, window, dt))
        for D in kfa.HEAD_DIMS:
            for causal in (True, False):
                r = kc.check_flash_head_dim(D, causal, dt)
                print(f"[check] flash_attention B=2 Hq=4 Hkv=2 D={D:<3d} S=70 "
                      f"{'causal' if causal else 'full  '} window=9 "
                      f"{str(dt)[6:]:8s} {r['variant']:5s} {_reading(r)}")
                if not r["ok"]:
                    failed.append(("flash_attention head dim", D, causal, dt))
    # -- 3b. the paper's Table I kernels vs plain versions -------------------------
    t1_errs, t1_failed = _table1_checks(kc)
    failed += t1_failed
    # expv on every f32 and bf16 bit pattern and at the round-half edges
    t0 = now()
    for what, r in kc.sweep_expv(kred.expv, ref.expv, dev).items():
        print(f"[sweep] expv kernel vs plain, {what}: {r['n']} inputs, {r['differ']} "
              f"differ in their bits, {r['nan_mismatch']} NaN on one side only, at "
              f"most {r['ulps']} ulp apart: {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failed.append(("expv sweep", what))
    print(f"[sweep] in {now() - t0:.1f}s")
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
    want_launches = {**{k: 0 for k in ops.LAUNCHES},
                     "matmul": 7 * L * forwards, "rmsnorm": (2 * L + 1) * forwards,
                     "flash_attention": L * n_prefill}
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
    _print_trace(_trace(engine.step, n_trace), n_trace, "decode steps at batch 4")
    engine.run()
    if not all(r.done for r in engine.finished):
        raise AssertionError("a traced request did not finish")
    _, logits = lm.prefill(engine.params,
                           torch.as_tensor(done[0].prompt, device=dev)[None],
                           cfg, 512)
    if logits.shape != (1, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"bad logits {logits.shape}")
    # where a whole-prompt prefill's device time goes: the longest prompt
    longest = torch.as_tensor(prompts[int(np.argmax(plens))], device=dev)[None]

    def prefill_once():
        _, lg = lm.prefill(engine.params, longest, cfg, 512)
        lg[0, -1, 0].item()              # a host read, as the engine's
    _print_trace(_trace(prefill_once, 2), 2,
                 f"whole-prompt prefills of {longest.shape[1]} tokens")
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
        want = {**{k: 0 for k in ops.LAUNCHES},
                "matmul": 7 * L * fwd, "rmsnorm": (2 * L + 1) * fwd,
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
            _print_trace(_trace(peng.step, n_trace), n_trace,
                         "decode steps at batch 8")
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

    # -- 5e. the Table I path: both configurations through ops -------------------
    path_launches["table1"] = _table1_path(kc, ops, ref, dev)

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

    rows, device_rows = {}, {}
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
                # between events, back-to-back calls of a small shape time the
                # host's launches; the trace gives the card's own time a call
                d_k = _device_per_call(lambda: kmm.matmul(a, pick()), 20)
                d_l = _device_per_call(lambda: torch.matmul(a, pick()), 20)
                device_rows[("matmul", M, K, N, dt)] = (d_k, d_l)
                print(f"[time] matmul {proj:7s} M={M:<4d} K={K:<5d} N={N:<5d} "
                      f"{kind:4s} {kmm.variant(M, K, N, dt):6s} kernel {t_k:.4f} ms  "
                      f"plain {t_p:.4f} ms  torch.matmul {t_l:.4f} ms  "
                      f"bound {bound:.4f} ms ({by}); device: kernel {d_k:.4f} ms, "
                      f"torch.matmul {d_l:.4f} ms, {d_k / d_l:.2f}x torch.matmul, "
                      f"{d_k / bound:.2f}x bound")
                del a, b, bs
    # the wgmma split plan against every count it may take, at the prefill
    # shapes where it splits: device ms a call (the plan's cost model,
    # WGMMA_STEP_US a K step and WGMMA_SPLIT_US a further slice, is read
    # from these); each count forced by lifting the plan's choice to it
    plan_knobs = (kmm.WGMMA_MAX_SPLITS, kmm.WGMMA_SPLIT_US)
    for M, K, N in ((128, 4096, 1024), (128, 4096, 4096), (128, 14336, 4096),
                    (223, 14336, 4096), (333, 4096, 1024)):
        a, b = kc.matmul_inputs(M, K, N, torch.bfloat16)
        chosen = kmm.wgmma_plan(M, K, N)[0]
        by_count = []
        for n in range(1, plan_knobs[0] + 1):
            kmm.WGMMA_MAX_SPLITS, kmm.WGMMA_SPLIT_US = n, 0.0
            kmm.wgmma_plan.cache_clear()
            kmm.matmul(a, b)
            by_count.append((kmm.wgmma_plan(M, K, N)[0],
                             _device_per_call(lambda: kmm.matmul(a, b), 20)))
        kmm.WGMMA_MAX_SPLITS, kmm.WGMMA_SPLIT_US = plan_knobs
        kmm.wgmma_plan.cache_clear()
        print(f"[time] matmul wgmma split plan M={M} K={K} N={N}: device ms by "
              f"slices " + ", ".join(f"{n}: {t:.4f}" for n, t in by_count)
              + f"; the plan takes {chosen}")
    # each variant's host cost a call: back-to-back calls at K = N = 64, where
    # the kernel takes a few us, between events (torch.matmul beside it)
    for M, dt in ((4, torch.bfloat16), (16, torch.bfloat16), (4, torch.float32)):
        a, b = kc.matmul_inputs(M, 64, 64, dt)
        t_k = time_ms(lambda: kmm.matmul(a, b), 500)
        t_l = time_ms(lambda: torch.matmul(a, b), 500)
        print(f"[time] matmul host cost M={M} K=64 N=64 {str(dt)[6:]:8s} "
              f"{kmm.variant(M, 64, 64, dt):6s} {1e3 * t_k:.1f} us a call "
              f"(torch.matmul {1e3 * t_l:.1f} us)")
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

    # flash attention at whole-prompt lengths (bf16, the model's dtype: the
    # dense path's 37 and 223, the paged path's 445, and 512; f32 at the
    # longest), beside SDPA on the same causal GQA function: between events,
    # and the device's own ms a call from one trace of both
    Hq, Hkv, D = kc.HQ, kc.HKV, kc.HEAD_DIM
    for S, dt in ((37, torch.bfloat16), (223, torch.bfloat16), (445, torch.bfloat16),
                  (512, torch.bfloat16), (512, torch.float32)):
        q, k, v = kc.flash_inputs(S, dt)
        iters = 50 if S > 100 else 200
        kern = lambda: kfa.flash_attention(q, k, v, causal=True)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        t_k = time_ms(kern, iters)
        t_p = time_ms(lambda: ref.attention(q, k, v, causal=True), iters)
        t_l = time_ms(sdpa, iters)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        var = kfa.variant(S, S, D, dt)
        d_k, d_l = _device_split(lambda: (kern(), sdpa()),
                                 PORT_KERNELS[f"flash_attention {var}"], 20)
        # q and out once, k and v once; 4 D operations per visible (q, k) pair
        bound, by = _ms_bound(q.element_size() * S * D * (2 * Hq + 2 * Hkv),
                              4.0 * D * Hq * S * (S + 1) / 2, kind)
        rows[("flash_attention", S, dt)] = (t_k, t_p, t_l, bound, by)
        device_rows[("flash_attention", S, dt)] = (d_k, d_l)
        print(f"[time] flash_attention B=1 Hq={Hq} Hkv={Hkv} D={D} S={S:<4d} "
              f"causal {kind:4s} {var:5s} kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
              f"SDPA {t_l:.4f} ms  bound {bound:.5f} ms ({by}); device: kernel "
              f"{d_k:.4f} ms, SDPA {d_l:.4f} ms, {d_k / d_l:.2f}x SDPA, "
              f"{d_k / bound:.1f}x bound")
    # each variant's host cost a call: back-to-back calls at 2 q heads of 16
    # rows, where each kernel takes a few us, between events, in turns; the
    # same bf16 inputs through each variant (the choice forced by lifting
    # `variant` to it), so the difference is the wgmma launch's own (its three
    # tensor maps encoded a call), and SDPA beside them
    q, k, v = (torch.randn((1, 16, h, D), device=dev).to(torch.bfloat16)
               .transpose(1, 2) for h in (2, 1, 1))
    chooser, host = kfa.variant, {}
    for turn in ("wgmma", "simt", "simt", "wgmma"):
        kfa.variant = lambda *a, _v=turn, **kw: _v
        host.setdefault(turn, []).append(
            1e3 * time_ms(lambda: kfa.flash_attention(q, k, v, causal=True), 500))
    kfa.variant = chooser
    t_l = 1e3 * time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 500)
    print(f"[time] flash_attention host cost B=1 Hq=2 Hkv=1 S=16 D={D} bf16, us a "
          f"call in turns: " + "; ".join(f"{n} " + " / ".join(f"{t:.1f}" for t in ts)
                                        for n, ts in host.items())
          + f" (SDPA {t_l:.1f})")

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
    t1_rows = _table1_times(kc, kred, kst, ref, time_ms, dev)

    # the decode-step shapes, where serving spends most of its time, and the
    # longest whole-prompt prefill; launches summed over the four main paths
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
             ("flash_attention", 1, 512, None, torch.bfloat16), "cuda",
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
        if kname == "matmul":            # the prefill regime beside decode's
            p_k, p_p, p_l, p_bound, p_by = rows[("matmul", 333, 4096, 14336,
                                                 torch.bfloat16)]
            kernels[-1]["prefill"] = {
                "shape": "M=333,K=4096,N=14336,bf16", "ms": p_k, "plain_ms": p_p,
                "library_ms": p_l, "bound_ms": p_bound, "bound_by": p_by,
                "max_abs_err": errs[("matmul", 333, 4096, 14336, torch.bfloat16)],
                "device_ms": device_rows[("matmul", 333, 4096, 14336,
                                          torch.bfloat16)][0],
                "library_device_ms": device_rows[("matmul", 333, 4096, 14336,
                                                  torch.bfloat16)][1]}
            kernels[-1]["device_ms"], kernels[-1]["library_device_ms"] = \
                device_rows[key]
        if kname == "flash_attention":
            kernels[-1]["device_ms"], kernels[-1]["library_device_ms"] = \
                device_rows[key]
    # the Table I kernels at table1-card (table1-paper beside them)
    for kname, key, err_key, source, replaces in (
            ("dotprod", ("dotprod", kc.TABLE1["table1-card"]["dot"]),
             ("dot", kc.TABLE1["table1-card"]["dot"]), "reduction.cu",
             "src/repro/kernels/reduction.py:58"),
            ("expv", ("expv", kc.TABLE1["table1-card"]["dot"]),
             ("expv", kc.TABLE1["table1-card"]["dot"]), "reduction.cu",
             "src/repro/kernels/reduction.py:103"),
            ("softmax_rows", ("softmax_rows", kc.TABLE1["table1-card"]["softmax"][0]),
             ("softmax", kc.TABLE1["table1-card"]["softmax"][0]), "reduction.cu",
             "src/repro/kernels/reduction.py:197"),
            ("jacobi2d", ("jacobi2d", kc.TABLE1["table1-card"]["jacobi"]),
             ("jacobi", kc.TABLE1["table1-card"]["jacobi"]), "stencil.cu",
             "src/repro/kernels/stencil.py:42"),
            ("fconv2d", ("fconv2d", kc.TABLE1["table1-card"]["conv"]),
             ("conv", kc.TABLE1["table1-card"]["conv"]), "stencil.cu",
             "src/repro/kernels/stencil.py:78")):
        t_k, t_p, t_l, bound, by, shape, _, _ = t1_rows[(kname, "table1-card")]
        p_k, p_p, p_l, p_bound, _, p_shape, p_d, p_ld = t1_rows[(kname, "table1-paper")]
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{source}",
                        "replaces": replaces, "launches": total[kname],
                        "launches_by_path": {p: pl[kname] for p, pl
                                             in path_launches.items()},
                        "max_abs_err": t1_errs[err_key], "ms": t_k,
                        "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                        "library_ms": t_l, "shape": f"table1-card {shape},f32",
                        "table1_paper": {"shape": p_shape, "ms": p_k,
                                         "device_ms": p_d, "plain_ms": p_p,
                                         "library_ms": p_l,
                                         "library_device_ms": p_ld,
                                         "bound_ms": p_bound}})
        if (kname, "host") in t1_rows:
            kernels[-1]["table1_paper"]["host_us"] = t1_rows[(kname, "host")]
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel never launched on the main paths: {total}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
