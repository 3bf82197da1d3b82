"""A kernel family's rows of ``PERF.md``'s kernel table for two checkouts in
turns (A, B, B, A), each turn a process of its own, on one CUDA card.

    python -m repro_torch.testing.kernel_ab matmul --tree parent=build/ab/parent --tree change=. [--out build/kernel_ab.json]
    python -m repro_torch.testing.kernel_ab flash --tree parent=build/ab/parent --tree change=.

A turn runs this file with ``PYTHONPATH=<tree>/src``, so that it imports
that tree's port and builds that tree's kernels from its sources (into its
own ``build/``); it uses only what both trees have.  Each family is a table
of rows (``FAMILIES``):

* ``matmul``, rows 2a-2e (``MATMUL_ROWS``: inputs from ``kernel_checks``,
  seed 0), through the wrapper a model calls (``matmul``; ``grad_a`` and
  ``grad_b`` for the backward's products): the kernel the tree's rule
  takes and, for f32, simt forced (the rule lifted to it), beside
  ``torch.matmul`` (f32 in full f32: TF32 off);
* ``flash``, rows 3a, 3c-3g and the seamless cross rows (``FLASH_ROWS``:
  bf16, inputs from seed 0 in the model's (B, S, H, D) layout), through
  ``flash_attention`` and ``backward`` (with the statistics autograd's
  forward keeps, where the tree has them; in such a tree every backward
  row also with each tensor-core backward forced,
  ``kernel_checks.forced_bwd_variant``, and every forward row as autograd
  runs it for a stats backward), beside SDPA (autograd of SDPA for a
  backward) with the kv heads expanded.

Each kernel is read as ms a call between CUDA events over back-to-back
calls and as device ms a call from a ``torch.profiler`` trace, by
``chip_smoke.py``'s measure (``_device_call``: each kernel name at the mean
of its kernels, times its launches a call), so that these readings and
phase 6's agree.  Prints one JSON line a turn, then a summary of medians;
``--out`` keeps them.  ``in_turns`` runs the turns of any such harness
(``decode_ab`` too).
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

#: (row, product, M, K, N, dtype name, calls): the matmul's rows
MATMUL_ROWS = (("2a", "fwd", 4, 4096, 14336, "bfloat16", 50),
               ("2b", "fwd", 333, 4096, 14336, "bfloat16", 20),
               ("2c dX", "dX", 4096, 4096, 14336, "bfloat16", 10),
               ("2c dW", "dW", 4096, 4096, 14336, "bfloat16", 10),
               ("2d", "fwd", 333, 4096, 14336, "float32", 10),
               ("2e dX", "dX", 4096, 4096, 14336, "float32", 2),
               ("2e dW", "dW", 4096, 4096, 14336, "float32", 2))
#: (row, pass, B, S, Sk, Hq, Hkv, D, causal): flash attention's rows
FLASH_ROWS = (("3a S=512", "fwd", 1, 512, 512, 32, 8, 128, True),
              ("3a S=445", "fwd", 1, 445, 445, 32, 8, 128, True),
              ("3a S=223", "fwd", 1, 223, 223, 32, 8, 128, True),
              ("3a S=37", "fwd", 1, 37, 37, 32, 8, 128, True),
              ("3c", "bwd", 4, 1024, 1024, 32, 8, 128, True),
              ("3d", "fwd", 1, 512, 512, 32, 32, 96, True),
              ("3e", "bwd", 4, 1024, 1024, 32, 32, 96, True),
              ("3f", "fwd", 4, 1024, 6404, 32, 8, 128, False),
              ("3g", "bwd", 4, 1024, 6404, 32, 8, 128, False),
              ("seamless cross", "fwd", 4, 1024, 256, 16, 16, 64, False),
              ("seamless cross", "bwd", 4, 1024, 256, 16, 16, 64, False),
              ("seamless encoder", "fwd", 4, 256, 256, 16, 16, 64, False))


def device_ms(fn, calls: int) -> float:
    """Device ms a call of ``fn`` from a trace of ``calls`` calls, as
    ``chip_smoke._device_call`` reads it: each kernel name at the mean of
    its kernels, times its launches a call (the trace's count over the
    calls, rounded, at least one), summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    return sum(max(1, round(len(us) / calls)) * sum(us) / len(us) / 1e3
               for us in by_name.values()) if by_name else float("nan")


def event_ms(fn, calls: int) -> float:
    """ms a call of ``fn`` between CUDA events over ``calls`` back-to-back
    calls, after three warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def _reading(fn, calls: int, variant: str) -> dict:
    return {"variant": variant, "ms": event_ms(fn, calls), "device_ms": device_ms(fn, calls)}


def _matmul_rows(dev) -> list:
    import torch

    from repro_torch.kernels import matmul as kmm
    from repro_torch.testing import kernel_checks as kc

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for row, prod, M, K, N, dt, calls in MATMUL_ROWS:
        dtype = getattr(torch, dt)
        if prod == "fwd":
            x, y = kc.matmul_inputs(M, K, N, dtype)
            kern, lib = (lambda: kmm.matmul(x, y)), (lambda: torch.matmul(x, y))
            taken = kmm.variant(M, K, N, dtype)
        elif prod == "dX":
            x, y = kc.matmul_bwd_inputs(M, K, N, dtype, "a")
            kern, lib = (lambda: kmm.grad_a(x, y)), (lambda: torch.matmul(x, y.T))
            taken = kmm.variant(M, N, K, dtype, trans=1)
        else:
            x, y = kc.matmul_bwd_inputs(M, K, N, dtype, "b")
            kern, lib = (lambda: kmm.grad_b(x, y)), (lambda: torch.matmul(x.T, y))
            taken = kmm.variant(K, M, N, dtype, trans=2)
        rec = {"row": row, "shape": [M, K, N, dt],
               "kernels": {"rule": _reading(kern, calls, taken)},
               "library_device_ms": device_ms(lib, calls)}
        if dtype == torch.float32 and taken != "simt":
            chooser = kmm.variant
            kmm.variant = lambda *_a, **_kw: "simt"
            try:
                rec["kernels"]["simt"] = _reading(kern, calls, "simt")
            finally:
                kmm.variant = chooser
        out.append(rec)
        del x, y
        torch.cuda.empty_cache()
    return out


def _flash_rows(dev) -> list:
    import contextlib

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.testing import kernel_checks as kc

    has_stats = hasattr(kfa, "STATS_MIN_SK")
    out = []
    for row, way, B, S, Sk, Hq, Hkv, D, causal in FLASH_ROWS:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn((B, n, h, D), generator=g, device=dev)
                       .to(torch.bfloat16).transpose(1, 2)
                       for n, h in ((S, Hq), (Sk, Hkv), (Sk, Hkv), (S, Hq)))
        ke, ve = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        rec = {"row": f"{row} {way}", "shape": [B, S, Sk, Hq, Hkv, D, causal],
               "kernels": {}}
        calls = 20 if way == "fwd" else 10
        # the rule's kernels; with the stats backward's tree, each backward
        # kernel forced, and the forward as autograd runs it for a stats
        # backward (writing the statistics)
        for kind in [None] + (["wgmma", "stats"] if has_stats else []):
            if way == "fwd" and kind == "wgmma":
                continue
            ctx = kc.forced_bwd_variant(kind) if kind else contextlib.nullcontext()
            with ctx:
                if way == "fwd":
                    fn = ((lambda: kfa._forward(q, k, v, causal, None, stats=True)) if kind
                          else (lambda: kfa.flash_attention(q, k, v, causal=causal)))
                    taken = kfa.variant(S, Sk, D, torch.bfloat16) + ("+stats" if kind else "")
                else:
                    extra = {}
                    if has_stats:
                        extra["stats"] = kfa._forward(q, k, v, causal, None, stats=True)[1]
                    fn = lambda: kfa.backward(q, k, v, do, causal=causal, **extra)
                    taken = kfa.bwd_variant(S, Sk, D, torch.bfloat16)
                rec["kernels"][kind or "rule"] = _reading(fn, calls, taken)
        if way == "fwd":
            lib = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=causal)
        else:
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, ke, ve))
            ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            lib = lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)
        rec["library_device_ms"] = device_ms(lib, 10)
        out.append(rec)
        del q, k, v, do, ke, ve
        torch.cuda.empty_cache()
    return out


#: each family: its rows' reader and the libraries it builds
FAMILIES = {"matmul": (_matmul_rows, ("matmul",)),
            "flash": (_flash_rows, ("flash_attention", "flash_attention_bwd"))}


def _turn(family: str) -> dict:
    # run as a file, this file's folder heads sys.path; the tree's port is
    # the one on PYTHONPATH
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    import torch

    import repro_torch
    from repro_torch.kernels import _build

    rows, libs = FAMILIES[family]
    _build.build(libs)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    return {"port": str(pathlib.Path(repro_torch.__file__).resolve().parent),
            "rows": rows(dev)}


def in_turns(script: str, trees: list, args: tuple = (), timeout: int = 1200) -> list:
    """``python script --turn *args`` once a turn, A, B, B, A for ``trees``
    ((name, root) twice), each from the tree's root with
    ``PYTHONPATH=<root>/src``; each turn's last JSON line, with ``"tree"``
    its name, printed as it comes.  Raises ``SystemExit`` on a failed turn."""
    (a, pa), (b, pb) = trees
    turns = []
    for name, root in ((a, pa), (b, pb), (b, pb), (a, pa)):
        root = pathlib.Path(root).resolve()
        proc = subprocess.run([sys.executable, script, "--turn", *args],
                              env={**os.environ, "PYTHONPATH": str(root / "src")},
                              capture_output=True, text=True, cwd=root, timeout=timeout)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{pathlib.Path(script).stem}: the turn of {name} failed")
        res = {"tree": name, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(res), flush=True)
        turns.append(res)
    return turns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.testing.kernel_ab",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a checkout; two of them")
    ap.add_argument("--out", default=None)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(_turn(args.family)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2:
        ap.error("give two --tree name=path")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[kernel_ab] {args.family}; {smi.stdout.strip()}")
    turns = in_turns(str(pathlib.Path(__file__).resolve()), trees, (args.family,))
    summary = {}
    for t in turns:
        for r in t["rows"]:
            s = summary.setdefault(r["row"], {"library": []})
            s["library"].append(r["library_device_ms"])
            for kind, k in r["kernels"].items():
                s.setdefault(f"{t['tree']} {kind} {k['variant']}", []).append(k["device_ms"])
    summary = {k: {t: statistics.median(v) for t, v in s.items()} for k, s in summary.items()}
    for k, s in summary.items():
        print(f"[kernel_ab] {k}: " + ", ".join(f"{t} {v:.4f}" for t, v in s.items()))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"family": args.family, "card": smi.stdout.strip(), "turns": turns,
             "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
