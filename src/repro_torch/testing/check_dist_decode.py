"""Distributed check: prefill and decode on a process mesh, with the decode
cache's slots cut over `model` (``cache_seq="model"``) and with the cache
cut over kv heads, and the vocab-sharded embedding lookup.

    PYTHONPATH=src python -m repro_torch.testing.check_dist_decode 2 2 --device cpu

runs 4 ranks on the CPU (gloo): llama3-8b's smoke model (kv 2, so a
`model` of 4 cuts through heads) and mixtral's (its window of 16 wraps the
ring cache; the MoE sublayers in ep mode) from the JAX initialiser's
weights: a 12-token prefill into a 32-slot cache, then 8 decode steps at
scalar positions on fixed tokens, each step's logits and the final caches
held to :func:`expected` (one process) at f32's limits, and each rank's
calls of the kernels' Functions to ``trainer.serve_launches``.
``tests/test_torch_dist_decode.py`` also holds them to the JAX package's
single-device decode; ``chip_smoke.py`` runs llama3-8b at its published
width, 1 layer, a 4,096-slot cache (1,024 a rank) for 16 steps with four
ranks on one card (``--size full``).  Imports only the port.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

#: f32 on both sides, sums in other orders (``tests/test_torch_serve.py``'s)
RTOL = ATOL = 1e-5
#: smoke: (archs, batch, prompt, cache slots, steps); full: llama3-8b's
SIZES = {"smoke": (("llama3-8b", "mixtral-8x7b"), 2, 12, 32, 8),
         "full": (("llama3-8b",), 4, 512, 4096, 16)}
#: the full size's cut: 1 of llama3-8b's 32 layers
FULL_LAYERS = 1
#: the cache rules each run takes
CACHES = ("cache_seq", "kv")


def config(arch: str, size: str):
    from repro_torch.configs import get_config, get_smoke_config

    if size == "smoke":
        return get_smoke_config(arch)
    return dataclasses.replace(get_config(arch), n_layers=FULL_LAYERS)


def tokens(cfg, size: str) -> tuple:
    """(prompt (B, P), the decode steps' tokens (steps, B, 1)), int64."""
    _, B, P, _, steps = SIZES[size]
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, (B, P))
    nxt = rng.integers(1, cfg.vocab_size, (steps, B, 1))
    return torch.from_numpy(prompt), torch.from_numpy(nxt)


def weights(arch: str, size: str, device) -> dict:
    """The whole tree: the JAX initialiser's smoke weights, or at the
    published width a seeded draw on ``device``."""
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.testing import train_checks as tc

    if size == "smoke":
        return tree_map(lambda t: t.to(device), tc.smoke_params(arch))
    return init_params(lm.model_defs(config(arch, size)),
                       torch.Generator(device).manual_seed(0), device)


def rules_for(mesh, cache: str, cfg, B: int):
    """``cache_seq``: the cache's slots cut over `model`; ``kv``: its kv
    heads cut over `model` where they divide (else whole on every rank)."""
    from repro_torch.parallel.sharding import default_rules

    if cache == "cache_seq":
        return default_rules(mesh, cache_seq="model", batch=B)
    return default_rules(mesh, kv_heads=cfg.n_kv_heads, batch=B)


def _decode(params, cfg, size, device, rules=None) -> dict:
    """Prefill, then the steps: each step's logits (B_loc, 1, V) and the
    final cache (this rank's blocks under ``rules``)."""
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import block

    _, B, P, W, steps = SIZES[size]
    prompt, nxt = tokens(cfg, size)
    spec = () if rules is None else rules.spec(("batch", ""))
    rows = (lambda t: t) if not spec else \
        (lambda t: block(t, spec, rules.mesh, rules.mesh.rank))
    with torch.no_grad():
        cache, logits = lm.prefill(params, rows(prompt).to(device), cfg, W,
                                   rules=rules)
        out = [logits]
        for i in range(steps):
            logits, cache = lm.decode_step(params, rows(nxt[i]).to(device), cache,
                                           P + i, cfg, rules=rules)
            out.append(logits)
    return {"logits": torch.stack(out), "cache": cache}


def expected(arch: str, size: str, device) -> dict:
    """One process's prefill and decode steps."""
    cfg = config(arch, size)
    return _decode(weights(arch, size, device), cfg, size, device)


def rank_main(args) -> None:
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.params import tree_map
    from repro_torch.parallel.sharding import block, shard_tree
    from repro_torch.kernels import ops
    from repro_torch.testing.check_dist_train import counting
    from repro_torch.testing.subproc import join, readings
    from repro_torch.train.trainer import serve_launches

    with join(args) as world:
        dev = world.device
        mesh = make_debug_mesh(world, *args.mesh)
        archs, B, *_ = SIZES[args.size]
        res = {"mesh": args.mesh, "runs": {}, "embed": {}}
        for arch in archs:
            cfg = config(arch, args.size)
            whole = weights(arch, args.size, dev)
            for cache in CACHES:
                rules = rules_for(mesh, cache, cfg, B)
                params = shard_tree(whole, lm.model_defs(cfg), rules, mesh.rank)
                if cache == CACHES[0]:
                    prompt, _ = tokens(cfg, args.size)
                    rows = block(prompt, rules.spec(("batch", "")), mesh, mesh.rank)
                    with torch.no_grad():
                        res["embed"][arch] = lm.embed_tokens(params, rows.to(dev), cfg,
                                                             rules).cpu()
                if dev.type == "cuda":
                    del whole
                ops.reset_launches()
                with readings(mesh, dev) as st, counting() as counts:
                    run = _decode(params, cfg, args.size, dev, rules)
                # the card's launch counters, or on the CPU the calls of the
                # Functions that launch there
                calls = dict(ops.LAUNCHES) if dev.type == "cuda" else counts
                want = serve_launches(cfg, 1, SIZES[args.size][4], rules=rules)
                res["runs"][(arch, cache)] = {
                    "logits": run["logits"].cpu(),
                    "cache": tree_map(lambda t: t.cpu(), run["cache"]), "stats": st,
                    "launches": ({k: calls[k] for k in counts},
                                 {k: want[k] for k in counts})}
                del params, run
                if dev.type == "cuda":
                    break                       # the card runs the cache_seq cut only
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def assemble(d, world: int, size: str) -> dict:
    """Each run's whole logits (steps+1, B, 1, V) and caches, and each
    arch's looked-up embedding rows (B, P, d)."""
    from repro_torch.models import lm
    from repro_torch.params import PV
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import gather_tree

    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]
    mesh = Mesh.abstract(ranks[0]["mesh"], ("data", "model"))
    _, B, P, W, steps = SIZES[size]
    out = {}
    for (arch, cache), run in ranks[0]["runs"].items():
        cfg = config(arch, size)
        rules = rules_for(mesh, cache, cfg, B)
        lg = {"l": PV((steps + 1, B, 1, cfg.padded_vocab), torch.float32,
                      ("", "batch", "", ""))}
        out[(arch, cache)] = {
            "logits": gather_tree([{"l": r["runs"][(arch, cache)]["logits"]}
                                   for r in ranks], lg, rules)["l"],
            "cache": gather_tree([r["runs"][(arch, cache)]["cache"] for r in ranks],
                                 lm.cache_defs(cfg, B, W), rules),
            "stats": [r["runs"][(arch, cache)]["stats"] for r in ranks],
            "launches": [r["runs"][(arch, cache)]["launches"] for r in ranks]}
    for arch in ranks[0]["embed"]:
        cfg = config(arch, size)
        rules = rules_for(mesh, CACHES[0], cfg, B)
        e = {"e": PV((B, P, cfg.d_model), cfg.dtype, ("batch", "", ""))}
        out[("embed", arch)] = gather_tree([{"e": r["embed"][arch]} for r in ranks],
                                           e, rules)["e"]
    return out


def main(argv=None) -> dict:
    from repro_torch.params import tree_leaves
    from repro_torch.testing.check_dist_moe import compare
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("prefill and decode on a process mesh against one process")
    ap.add_argument("nd", type=int, nargs="?", default=2)
    ap.add_argument("nm", type=int, nargs="?", default=2)
    ap.add_argument("--size", choices=tuple(SIZES), default="smoke")
    args = ap.parse_args(argv)
    args.mesh = (args.nd, args.nm)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    world = args.nd * args.nm
    d = run_ranks("repro_torch.testing.check_dist_decode", world, str(args.nd),
                  str(args.nm), "--size", args.size, device=args.device,
                  workdir=args.dir)
    got = assemble(d, world, args.size)
    worst = 0.0
    for key, run in got.items():
        if key[0] == "embed":
            continue
        want = expected(key[0], args.size, "cpu")
        use = {"logits": compare(run["logits"], want["logits"], RTOL, ATOL),
               "cache": max(compare(a, b, RTOL, ATOL) for a, b in
                            zip(tree_leaves(run["cache"]), tree_leaves(want["cache"])))}
        worst = max(worst, *use.values())
        same = all(got == want for got, want in run["launches"])
        print(f"check_dist_decode {key[0]} {key[1]} mesh {args.nd}x{args.nm}: "
              f"limit use {use}; calls a rank == serve_launches: {same}")
        worst = worst if same else float("inf")
    if worst > 1.0:
        raise AssertionError(f"check_dist_decode failed (limit use {worst:.3g})")
    print(f"check_dist_decode OK (mesh {args.nd}x{args.nm})")
    return got


if __name__ == "__main__":
    main(sys.argv[1:])
