"""Open-loop serving load: Poisson arrivals over a Zipf-popular prompt pool.

The port's counterpart of ``repro.serve.traffic``.  Open loop means arrivals
do not wait for the server: request i becomes submittable at a fixed offset
on the host clock, drawn from exponential interarrival gaps, whether or not
the engine has kept up, so queueing delay shows in TTFT.  Prompt popularity
is Zipfian over a small pool cut from the synthetic corpus
(``data/pipeline.py``), which makes shared-prefix block reuse a first-class
effect.  Every clock read goes through ``testing.timing.now``.

CLI (runs on the card unless ``--device cpu``; smoke-sized model from
``--seed``)::

    PYTHONPATH=src python -m repro_torch.serve.traffic --configs dense,paged,paged_chunked

prints one ``serve/<tag>,...`` CSV line and one ``serve_json {...}`` line
per config.  Run in a process group of 8 ranks, each engine serves on the
reference's (2, 2, 2) (pod, data, model) mesh with its three-level
topology (:func:`mesh_arm`), and the ranks agree on the load's clock
(rank 0's, each loop) so that they admit the same requests at the same
step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.serve.engine import Request
from repro_torch.testing.timing import now


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    n_requests: int = 24
    rate_rps: float = 20.0      # Poisson arrival rate (requests / second)
    zipf_a: float = 1.1         # prompt-popularity exponent over the pool
    pool_size: int = 6
    min_prompt: int = 4
    max_prompt: int = 24
    max_new: int = 16
    vocab_size: int = 512
    seed: int = 0


def prompt_pool(lc: LoadConfig) -> list[np.ndarray]:
    """Pool of distinct prompts cut from the synthetic corpus rows (Zipf
    unigrams + Markov bigrams), with per-prompt lengths drawn uniformly."""
    dc = DataConfig(vocab_size=lc.vocab_size, seq_len=lc.max_prompt,
                    global_batch=lc.pool_size, seed=lc.seed)
    rows = SyntheticCorpus(dc).batch(0)
    rng = np.random.default_rng(lc.seed)
    lens = rng.integers(lc.min_prompt, lc.max_prompt + 1, lc.pool_size)
    return [r[:n].astype(np.int32).copy() for r, n in zip(rows, lens)]


def request_schedule(lc: LoadConfig) -> tuple[np.ndarray, np.ndarray]:
    """(arrival offsets seconds, pool index) per request: exponential
    interarrival gaps (Poisson process) + Zipf-ranked pool popularity."""
    rng = np.random.default_rng(lc.seed + 1)
    arrivals = np.cumsum(rng.exponential(1.0 / lc.rate_rps, lc.n_requests))
    ranks = np.arange(1, lc.pool_size + 1, dtype=np.float64)
    p = ranks ** (-lc.zipf_a)
    p /= p.sum()
    idx = rng.choice(lc.pool_size, size=lc.n_requests, p=p)
    return arrivals, idx


def _mesh_of(engine):
    """The process mesh an engine (or a router's first engine) serves on."""
    eng = getattr(engine, "engines", [engine])[0]
    rules = getattr(eng, "rules", None)
    return None if rules is None else rules.mesh


def _agreed(t: float, mesh) -> float:
    """``t`` on this rank, or under a mesh the latest of the ranks' ``t``
    (every rank then submits the same requests at the same step)."""
    if mesh is None or mesh.transport is None:
        return t
    import torch

    from repro_torch.parallel.comm import all_reduce_raw
    import torch.distributed as dist

    return float(all_reduce_raw(torch.tensor([t], dtype=torch.float64),
                                mesh.axis_names, mesh, op=dist.ReduceOp.MAX))


def run_open_loop(engine, lc: LoadConfig, *, max_steps: int = 100_000) -> dict:
    """Drive ``engine`` (any object with submit/step/n_live/n_waiting/
    capacity/peak_live, a router included) under the open-loop schedule;
    returns the metrics of the run."""
    pool = prompt_pool(lc)
    arrivals, idx = request_schedule(lc)
    reqs = [Request(rid=i, prompt=pool[j], max_new_tokens=lc.max_new)
            for i, j in enumerate(idx)]
    ttft: dict[int, float] = {}
    occ: list[float] = []
    submitted = steps = 0
    mesh = _mesh_of(engine)
    t0 = now()
    while steps < max_steps:
        t = _agreed(now() - t0, mesh)
        while submitted < len(reqs) and arrivals[submitted] <= t:
            engine.submit(reqs[submitted])
            submitted += 1
        worked = engine.step()
        tnow = now() - t0
        for r in reqs[:submitted]:
            if r.out and r.rid not in ttft:
                ttft[r.rid] = tnow
        if worked:                  # slot utilization of actual engine steps
            occ.append(engine.n_live / engine.capacity)
        # an idle step while arrivals are still due waits for them and is
        # not counted: on a fast engine idle steps take microseconds, and
        # counting them ran max_steps out before the first arrival
        steps += worked or submitted == len(reqs)
        if submitted == len(reqs) and not worked and engine.n_waiting == 0 \
                and engine.n_live == 0:
            break
    wall = now() - t0
    done = [r for r in reqs if r.done]
    gen_tokens = sum(len(r.out) for r in reqs)
    ttft_ms = sorted(1e3 * (ttft[r.rid] - arrivals[r.rid])
                     for r in reqs if r.rid in ttft)
    pct = (lambda q: ttft_ms[min(len(ttft_ms) - 1,
                                 int(q * (len(ttft_ms) - 1)))]) \
        if ttft_ms else (lambda q: 0.0)
    return {
        "n_requests": lc.n_requests,
        "completed": len(done),
        "ttft_p50_ms": round(pct(0.50), 3),
        "ttft_p99_ms": round(pct(0.99), 3),
        "decode_tok_s": round(gen_tokens / max(wall, 1e-9), 3),
        "occupancy": round(float(np.mean(occ)) if occ else 0.0, 4),
        "max_concurrent": int(engine.peak_live),
        "wall_s": round(wall, 3),
    }


# ---------------------------------------------------------------------------
# CLI: dense vs paged vs chunked at equal KV memory
# ---------------------------------------------------------------------------

_MESH_ARM: dict = {}


def mesh_arm(cfg, device) -> tuple:
    """(rules, topology) of the reference's mesh arm: with a process group
    of 8 ranks, the (2, 2, 2) (pod, data, model) mesh (made once a
    process), the serving rules on it (the batch whole, the kv heads cut
    where they divide) and the three-level topology; else (None, None)."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == 8):
        return None, None
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.comm import current_world
    from repro_torch.parallel.sharding import default_rules
    from repro_torch.topology import Topology

    if "mesh" not in _MESH_ARM:
        _MESH_ARM["mesh"] = make_mesh(current_world(torch.device(device).type),
                                      (2, 2, 2), ("pod", "data", "model"))
    topo = Topology.from_levels([("pod", 2, 8.0), ("data", 2, 4.0), ("model", 2, 2.0)])
    return default_rules(_MESH_ARM["mesh"], kv_heads=cfg.n_kv_heads, batch=1), topo


def _build(tag: str, model, args):
    """One engine per arm, all at EQUAL KV memory: the dense engine holds
    ``dense_batch * max_seq`` token-slots; the paged pool holds the same
    token count in ``n_blocks`` blocks but serves ``max_batch`` slots.
    With 8 ranks the engines serve on the mesh arm (:func:`mesh_arm`)."""
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    from repro_torch.serve.paged import (PagedServeConfig, PagedServingEngine,
                                         kv_token_bytes)

    rules, topo = mesh_arm(model.cfg, args.device)
    bt = args.block_tokens
    n_blocks = args.dense_batch * args.max_seq // bt   # equal token capacity
    per_tok = kv_token_bytes(model.cfg)
    if tag == "dense":
        scfg = ServeConfig(max_batch=args.dense_batch, max_seq=args.max_seq)
        eng = ServingEngine(model, scfg, rules=rules, topology=topo,
                            device=args.device)
        conf = {"max_batch": scfg.max_batch, "max_seq": scfg.max_seq,
                "block_tokens": 0, "chunk": 0}
        kv_cap = scfg.max_batch * scfg.max_seq * per_tok
        kv_peak = lambda: kv_cap                       # dense: always resident
    elif tag in ("paged", "paged_chunked"):
        chunk = args.chunk if tag == "paged_chunked" else 0
        scfg = PagedServeConfig(max_batch=args.max_batch,
                                max_seq=args.max_seq, block_tokens=bt,
                                n_blocks=n_blocks, chunk=chunk)
        eng = PagedServingEngine(model, scfg, rules=rules, device=args.device)
        conf = {"max_batch": scfg.max_batch, "max_seq": scfg.max_seq,
                "block_tokens": bt, "chunk": chunk}
        kv_cap = n_blocks * bt * per_tok
        kv_peak = eng.kv_bytes_resident_peak
    else:
        raise ValueError(f"unknown config {tag!r}: dense, paged, paged_chunked")
    return eng, conf, kv_cap, kv_peak


def main(argv=None) -> int:
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.params import init_params
    from repro_torch.serve.engine import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--configs", default="dense,paged,paged_chunked",
                    help="comma-separated: dense, paged, paged_chunked")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--pool", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="paged engine slots")
    ap.add_argument("--dense-batch", type=int, default=2,
                    help="dense slots at the same KV memory")
    ap.add_argument("--block-tokens", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = lm.Model(cfg, init_params(lm.model_defs(cfg), gen, device))
    lc = LoadConfig(n_requests=args.requests, rate_rps=args.rate,
                    pool_size=args.pool, max_prompt=args.max_prompt,
                    max_new=args.max_new, vocab_size=cfg.vocab_size,
                    seed=args.seed)
    for tag in args.configs.split(","):
        tag = tag.strip()
        eng, conf, kv_cap, kv_peak = _build(tag, model, args)
        metrics = run_open_loop(eng, lc)
        if hasattr(eng, "shutdown") and eng.n_live == 0 \
                and eng.n_waiting == 0:
            eng.shutdown()      # leaked KV blocks fail the run loudly
        metrics["kv_bytes_capacity"] = int(kv_cap)
        metrics["kv_bytes_resident_peak"] = int(kv_peak())
        conf["rate_rps"] = lc.rate_rps
        rec = {"tag": tag, "device": str(device), "config": conf, **metrics}
        print(f"serve/{tag},{metrics['ttft_p50_ms']},{metrics['ttft_p99_ms']},"
              f"{metrics['decode_tok_s']},{metrics['occupancy']},"
              f"{metrics['max_concurrent']}")
        print("serve_json " + json.dumps(rec, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
