"""Flash attention's rows of ``PERF.md``'s kernel table (3a, 3c-3g and the
seamless cross rows) for two checkouts in turns (A, B, B, A), each turn a
process of its own, on one CUDA card.

    python -m repro_torch.testing.flash_ab --tree parent=build/ab/parent --tree change=. [--out chiprun_out/flash_ab.json]

A turn runs this file with ``PYTHONPATH=<tree>/src``, so that it imports
that tree's port and builds that tree's flash kernels from its sources (into
its own ``build/``).  For each row (``ROWS``: bf16, inputs from seed 0 in the
model's (B, S, H, D) layout) it reads, through the wrapper a model calls
(``flash_attention``; ``backward`` with the statistics autograd's forward
keeps, where the tree has them): the kernel's ms a call between CUDA events
over back-to-back calls, its device ms a call from a ``torch.profiler``
trace (every kernel of the call), and SDPA's (autograd of SDPA's for a
backward) device ms on the same inputs with the kv heads expanded.  In a
tree with the ``stats`` backward every backward row is also read with each
tensor-core backward forced (``kernel_checks.forced_bwd_variant``), the
readings ``bwd_variant``'s rule is set from, and every forward row as
autograd runs it for a stats backward (writing the statistics).  Prints
one JSON line a turn, then a summary of medians; ``--out`` keeps them.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

#: (row, pass, B, S, Sk, Hq, Hkv, D, causal): the kernel table's shapes
ROWS = (("3a S=512", "fwd", 1, 512, 512, 32, 8, 128, True),
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


def _device_ms(fn, calls: int) -> float:
    """Device ms a call: every kernel of ``calls`` calls in a trace, summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / calls


def _event_ms(fn, calls: int) -> float:
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


def _turn() -> dict:
    # run as a file, this file's folder heads sys.path; the tree's port is
    # the one on PYTHONPATH
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    import contextlib

    import torch
    import torch.nn.functional as F

    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.testing import kernel_checks as kc

    _build.build(("flash_attention", "flash_attention_bwd"))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    has_stats = hasattr(kfa, "STATS_MIN_SK")
    out = {"port": str(pathlib.Path(repro_torch.__file__).resolve().parent), "rows": []}
    for row, way, B, S, Sk, Hq, Hkv, D, causal in ROWS:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn((B, n, h, D), generator=g, device=dev)
                       .to(torch.bfloat16).transpose(1, 2)
                       for n, h in ((S, Hq), (Sk, Hkv), (Sk, Hkv), (S, Hq)))
        ke, ve = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
        rec = {"row": row, "pass": way, "shape": [B, S, Sk, Hq, Hkv, D, causal]}
        calls = 20 if way == "fwd" else 10
        # the rule's kernels; with the stats backward's tree, each backward
        # kernel forced, and the forward as autograd runs it for a stats
        # backward (writing the statistics)
        kinds = [None] + (["wgmma", "stats"] if has_stats else [])
        for kind in kinds:
            ctx = kc.forced_bwd_variant(kind) if kind else contextlib.nullcontext()
            with ctx:
                if way == "fwd":
                    if kind == "wgmma":
                        continue
                    fn = ((lambda: kfa._forward(q, k, v, causal, None, stats=True)) if kind
                          else (lambda: kfa.flash_attention(q, k, v, causal=causal)))
                    taken = kfa.variant(S, Sk, D, torch.bfloat16) + ("+stats" if kind else "")
                else:
                    extra = {}
                    if has_stats:
                        extra["stats"] = kfa._forward(q, k, v, causal, None, stats=True)[1]
                    fn = lambda: kfa.backward(q, k, v, do, causal=causal, **extra)
                    taken = kfa.bwd_variant(S, Sk, D, torch.bfloat16)
                rec[kind or "rule"] = {"variant": taken, "ms": _event_ms(fn, calls),
                                       "device_ms": _device_ms(fn, calls)}
        if way == "fwd":
            lib = lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=causal)
        else:
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, ke, ve))
            ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            lib = lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True)
        rec["sdpa_device_ms"] = _device_ms(lib, 10)
        out["rows"].append(rec)
        del q, k, v, do, ke, ve
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="name=path of a checkout; two of them")
    ap.add_argument("--out", default=None)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(_turn()))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) != 2:
        ap.error("give two --tree name=path")
    (a, pa), (b, pb) = trees.items()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[flash_ab] {smi.stdout.strip()}")
    turns = []
    for name, path in ((a, pa), (b, pb), (b, pb), (a, pa)):
        env = {**os.environ, "PYTHONPATH": str(pathlib.Path(path).resolve() / "src")}
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--turn"], env=env, capture_output=True, text=True,
                              cwd=path, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = name
        turns.append(res)
        print(json.dumps(res))
    summary = {}
    for t in turns:
        for r in t["rows"]:
            key = f"{r['row']} {r['pass']}"
            s = summary.setdefault(key, {"sdpa_device_ms": []})
            s["sdpa_device_ms"].append(r["sdpa_device_ms"])
            for kind in ("rule", "wgmma", "stats"):
                if kind in r:
                    tag = f"{t['tree']} {kind} {r[kind]['variant']}"
                    s.setdefault(tag, []).append(r[kind]["device_ms"])
    summary = {k: {t: statistics.median(v) for t, v in s.items()} for k, s in summary.items()}
    for k, s in summary.items():
        print(f"[flash_ab] {k}: " + ", ".join(f"{t} {v:.4f}" for t, v in s.items()))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(
            {"card": smi.stdout.strip(), "turns": turns, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
