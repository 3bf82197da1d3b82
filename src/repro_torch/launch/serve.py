"""Serving launcher: batched requests against a (smoke or full) model.

The port's counterpart of ``repro.launch.serve`` in dense mode.  Runs on
the card unless ``--device cpu``; weights are random, drawn from ``--seed``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm
from repro_torch.params import init_params
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.serve.engine import resolve_device
from repro_torch.testing.timing import now


def run(arch: str, *, smoke: bool = True, n_requests: int = 6,
        max_new: int = 16, max_batch: int = 4, max_seq: int = 128,
        paged: bool = False, pods: int = 1, seed: int = 0, device="cuda"):
    if paged:
        raise NotImplementedError("--paged is not ported yet (the paged "
                                  "serving slice)")
    if pods != 1:
        raise NotImplementedError("--pods is not ported yet (the "
                                  "distributed slice)")
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = lm.Model(cfg, init_params(lm.model_defs(cfg), gen, device))
    engine = ServingEngine(model, ServeConfig(max_batch=max_batch,
                                              max_seq=max_seq), device=device)
    rng = np.random.default_rng(seed)
    t0 = now()
    for rid in range(n_requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(1, cfg.vocab_size, plen).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    finished = engine.run()
    dt = now() - t0                     # run() ends on a host read of tokens
    toks = sum(len(r.out) for r in finished)
    print(f"[serve] {len(finished)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. kernel builds) [dense, {device}]")
    return finished


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", dest="smoke", action="store_true",
                      default=True, help="reduced same-family config")
    size.add_argument("--full", dest="smoke", action="store_false",
                      help="the published configuration")
    ap.add_argument("--paged", action="store_true",
                    help="block-table KV pool (not ported yet)")
    ap.add_argument("--pods", type=int, default=1,
                    help="engines behind a router (not ported yet)")
    args = ap.parse_args(argv)
    run(args.arch, smoke=args.smoke, n_requests=args.requests,
        max_new=args.max_new, max_batch=args.max_batch, max_seq=args.max_seq,
        paged=args.paged, pods=args.pods, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
