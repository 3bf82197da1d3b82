"""Dense decode ms a step of two checkouts in turns (A, B, B, A), each turn
a process of its own, on one CUDA card.

    python -m repro_torch.testing.decode_ab --tree parent=build/ab/parent --tree change=. [--runs 3] [--out build/decode_ab.json]

A turn runs this file with ``PYTHONPATH=<tree>/src``, so that it imports
that tree's port and builds that tree's kernels from its sources (into its
own ``build/``).  It draws llama3-8b at full width and depth from seed 0 on
the card and serves ``chip_smoke.py`` phase 5's dense workload through
``ServingEngine`` (8 requests of 32-256 tokens from seed 0, 16 new tokens
each, batch 4, 512 slots) ``--runs`` times: decode ms a step from the
engine's own host-clock spans, the launches, and a digest of the streams.
It then reads the host µs of issuing one ``ops.matmul`` at (4, 4096) @
(4096, 4096) bf16 (256 calls queued without a synchronisation, so the
reading is the host's: the card takes each call in ~10 µs and its queue
does not fill), in turns: with no autotune table and, where the tree has
``kernels.autotune``, inside ``tuned()`` with a table that holds the
signature's own plan and inside one with an empty table.  It uses only
what both trees have (``ServingEngine``, ``lm``, ``init_params``,
``kernels._build.build``, ``ops``).  Prints one JSON line a turn and a
summary; ``--out`` keeps them.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys


def _turn(runs: int) -> dict:
    import contextlib
    import hashlib

    # run as a file, this file's folder heads sys.path; the tree's port is
    # the one on PYTHONPATH
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models import lm
    from repro_torch.params import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    from repro_torch.testing.timing import now

    _build.build(("matmul", "rmsnorm", "flash_attention"))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cfg = get_config("llama3-8b")
    model = lm.Model(cfg, init_params(lm.model_defs(cfg),
                                      torch.Generator(dev).manual_seed(0), dev))
    out = {"port": str(pathlib.Path(repro_torch.__file__).resolve().parent),
           "decode_ms": [], "launches": None, "streams": None}
    for _ in range(runs):
        engine = ServingEngine(model, ServeConfig(max_batch=4, max_seq=512), device=dev)
        prng = np.random.default_rng(0)
        plens = [int(n) for n in prng.integers(32, 257, 8)]
        ops.reset_launches()
        for rid, n in enumerate(plens):
            engine.submit(Request(rid=rid, max_new_tokens=16,
                                  prompt=prng.integers(1, cfg.vocab_size, n)))
        done = sorted(engine.run(), key=lambda r: r.rid)
        tm = engine.timing
        out["decode_ms"].append(1e3 * tm["decode_s"] / tm["decode_steps"])
        out["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        out["streams"] = hashlib.sha256(json.dumps(
            [[int(t) for t in r.out] for r in done]).encode()).hexdigest()[:16]
        del engine
    del model
    torch.cuda.empty_cache()

    a = torch.randn(4, 4096, device=dev).to(torch.bfloat16)
    b = (torch.randn(4096, 4096, device=dev) * 4096 ** -0.5).to(torch.bfloat16)
    try:
        from repro_torch.kernels import autotune as at
    except ImportError:
        at = None
    modes = {"no table": contextlib.nullcontext}
    if at is not None:
        sig = at.signature("matmul", (4, 4096, 4096), "bfloat16", "host-us")
        own = at.default_config("matmul", (4, 4096, 4096), "bfloat16")

        def with_entry():
            ctx = at.TuneContext(topology_tag="host-us")
            ctx.table[sig] = {"winner": own}
            return at.tuned(ctx)
        modes["tuned(), its own plan"] = with_entry
        modes["tuned(), empty table"] = lambda: at.tuned(at.TuneContext(topology_tag="host-us"))
    calls, host = 256, {m: [] for m in modes}
    for _ in range(9):
        for mode, ctx in modes.items():
            with ctx():
                for _ in range(8):
                    ops.matmul(a, b)
                torch.cuda.synchronize()
                t0 = now()
                for _ in range(calls):
                    ops.matmul(a, b)
                host[mode].append((now() - t0) * 1e6 / calls)
                torch.cuda.synchronize()
    out["matmul_host_us"] = {m: statistics.median(v) for m, v in host.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.testing.decode_ab",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=DIR, a checkout's root; two of them")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(_turn(args.runs)), flush=True)
        return 0
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2:
        ap.error("give two --tree NAME=DIR")
    (na, da), (nb, db) = trees
    results = []
    for name, root in ((na, da), (nb, db), (nb, db), (na, da)):
        root = pathlib.Path(root).resolve()
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), "--turn",
             "--runs", str(args.runs), "--tree", f"{name}={root}"],
            capture_output=True, text=True, timeout=900, cwd=root,
            env={**os.environ, "PYTHONPATH": str(root / "src")})
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"decode_ab: the turn of {name} failed")
        r = {"tree": name, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(r), flush=True)
        results.append(r)
    for name in (na, nb):
        mine = [r for r in results if r["tree"] == name]
        ms = [m for r in mine for m in r["decode_ms"]]
        host = "; ".join(f"{mode} {statistics.median(r['matmul_host_us'][mode] for r in mine):.3f}"
                         for mode in mine[0]["matmul_host_us"])
        print(f"decode_ab: {name}: decode ms a step {[round(m, 3) for m in ms]}, "
              f"median {statistics.median(ms):.3f}; ops.matmul host us a call: {host}",
              flush=True)
    same = len({r["streams"] for r in results}) == 1 and \
        len({json.dumps(r["launches"], sort_keys=True) for r in results}) == 1
    print(f"decode_ab: streams and launches the same in every turn: {same}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
