"""Serving launcher: batched requests against a (smoke or full) model.

The port's counterpart of ``repro.launch.serve``.  ``--paged`` swaps the
dense per-slot KV cache for the block-table pool (``serve.paged``):
``--block-tokens`` sizes the blocks (0 = the autotune table's inside
``kernels.autotune.tuned()``, else 16; lowered to a power-of-two divisor
of ``--max-seq``) and ``--chunk`` enables chunked prefill.
``--pods N`` splits the request stream across N engines on the one device,
sharing one model, behind the prefix-affinity router (``serve.router``).
``--arch`` takes the dense family, the MoE family (mixtral-8x7b,
qwen3-moe-235b-a22b), mamba2-370m and the jamba hybrid
(jamba-1.5-large-398b); the paged engine refuses a windowed model
(mixtral) and a Mamba state (mamba2, jamba), as the reference's does.  The
cross-attention families (encdec, vlm) are refused before any weight is
drawn: the engines take no context, as the reference's does not
(``serve.engine.refuse_context``).
Runs on the card unless ``--device cpu``; weights are random, drawn from
``--seed`` (a smoke model's on the CPU, so the card serves the same one).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --paged --chunk 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.autotune import block_tokens, tuned_config
from repro_torch.models import lm
from repro_torch.params import init_params, tree_map
from repro_torch.serve import (PagedServeConfig, PagedServingEngine,
                               PrefixRouter, Request, ServeConfig,
                               ServingEngine)
from repro_torch.serve.engine import refuse_context, resolve_device
from repro_torch.serve.paged import max_block_tokens
from repro_torch.testing.timing import now


def _block_tokens(cfg, max_batch: int, max_seq: int, default: int = 16) -> int:
    """Tokens a block of the paged pool (the twin of the reference's
    ``ops.paged_block_tokens``): the tuned ``paged_attention`` ``bt`` of
    this decode signature where the ambient autotune table has one (never
    outside ``kernels.autotune.tuned()``), else ``default``; lowered to a
    power-of-two divisor of ``max_seq`` the kernel takes, so the pool tiles
    ``max_seq`` exactly."""
    tuned = tuned_config("paged_attention", (max_batch, cfg.n_heads, cfg.n_kv_heads,
                                             max_seq, cfg.head_dim), cfg.dtype) or {}
    return block_tokens(max_seq, min(int(tuned.get("bt", default)),
                                     max_block_tokens(cfg)))


def _make_engine(model, device, *, paged: bool, max_batch: int,
                 max_seq: int, block_tokens: int, chunk: int):
    if not paged:
        return ServingEngine(model, ServeConfig(max_batch=max_batch,
                                                max_seq=max_seq), device=device)
    bt = block_tokens if block_tokens > 0 else _block_tokens(model.cfg, max_batch,
                                                             max_seq)
    scfg = PagedServeConfig(max_batch=max_batch, max_seq=max_seq,
                            block_tokens=bt, n_blocks=max_batch * max_seq // bt,
                            chunk=chunk)
    return PagedServingEngine(model, scfg, device=device)


def run(arch: str, *, smoke: bool = True, n_requests: int = 6,
        max_new: int = 16, max_batch: int = 4, max_seq: int = 128,
        paged: bool = False, block_tokens: int = 0, chunk: int = 0,
        pods: int = 1, seed: int = 0, device="cuda"):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    refuse_context(cfg)
    device = resolve_device(device)
    # a smoke model's weights are drawn on the CPU and moved, so the card
    # and the CPU serve the same model (their generators draw different
    # numbers); a full one is drawn where it runs
    draw = torch.device("cpu") if smoke else device
    params = init_params(lm.model_defs(cfg),
                         torch.Generator(device=draw).manual_seed(seed), draw)
    model = lm.Model(cfg, tree_map(lambda t: t.to(device), params))
    engines = [_make_engine(model, device, paged=paged, max_batch=max_batch,
                            max_seq=max_seq, block_tokens=block_tokens,
                            chunk=chunk)
               for _ in range(max(pods, 1))]
    front = engines[0] if len(engines) == 1 else PrefixRouter(engines)
    rng = np.random.default_rng(seed)
    t0 = now()
    for rid in range(n_requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(1, cfg.vocab_size, plen).astype(np.int32)
        front.submit(Request(rid=rid, prompt=prompt, max_new_tokens=max_new))
    finished = front.run()
    dt = now() - t0                     # run() ends on a host read of tokens
    toks = sum(len(r.out) for r in finished)
    mode = ("paged+chunked" if paged and chunk else
            "paged" if paged else "dense")
    pods_txt = f" pods={len(engines)}" if len(engines) > 1 else ""
    print(f"[serve] {len(finished)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. kernel builds) [{mode}{pods_txt}, "
          f"{device}]")
    return finished


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    help="a registered arch: dense, MoE (mixtral-8x7b, "
                         "qwen3-moe-235b-a22b), mamba2-370m or "
                         "jamba-1.5-large-398b; not the encdec or vlm ones, "
                         "whose context no engine takes")
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
                    help="block-table KV pool instead of dense slots")
    ap.add_argument("--block-tokens", type=int, default=0,
                    help="tokens per KV block (0 = the autotune table's "
                         "inside tuned(), else 16; lowered to divide "
                         "--max-seq)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="chunked-prefill chunk size (0 = whole-prompt)")
    ap.add_argument("--pods", type=int, default=1,
                    help="engines behind the prefix-affinity router")
    args = ap.parse_args(argv)
    return run(args.arch, smoke=args.smoke, n_requests=args.requests,
               max_new=args.max_new, max_batch=args.max_batch,
               max_seq=args.max_seq, paged=args.paged,
               block_tokens=args.block_tokens, chunk=args.chunk,
               pods=args.pods, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
