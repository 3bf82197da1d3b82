"""Distributed check: paged-KV serving on a (2, 2, 2) (pod, data, model)
mesh of 8 ranks.

The port's twin of ``repro.testing.check_serve_paged``.  The dense
``ServingEngine`` and the ``PagedServingEngine`` (whole-prompt and chunked
prefill) run the same request stream with the same rules on the same mesh;
every rank runs all of them (``testing.subproc.run_ranks``), the pool
holding the rank's kv heads.  Asserted, as the reference asserts:

  1. *the same tokens*: dense, paged and chunked streams equal request by
     request;
  2. *block reuse*: the duplicate prompts become shared-prefix hits, and a
     shared block that must diverge is copied (COW);
  3. *hygiene*: after the run every block is free (``shutdown``) and the
     zero block is still zero on every rank;
  4. *chunked prefill* ran in chunks;
  5. *router affinity*: behind ``PrefixRouter`` (two paged engines on the
     same mesh), a repeated prompt goes to the pod that served it first.

Each engine's greedy logits are kept (``logit_log``) and each rank's
kernel calls are held to ``trainer.serve_launches``.
``tests/test_torch_serve_mesh.py`` also holds the streams to the JAX
package's single-device engine; ``chip_smoke.py`` (phase 13, ``--size
full``) runs llama3-8b at its published width, 1 of 32 layers.

    PYTHONPATH=src python -m repro_torch.testing.check_serve_paged --device cpu
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from repro_torch.testing import check_serve_topology as cst

RANKS = cst.RANKS
#: (block tokens, blocks in the pool, chunk, new tokens a request)
PAGED = {"smoke": (8, 32, 16, 8), "full": (16, 256, 128, 16)}


def prompts(size: str) -> list:
    """The reference's stream: duplicates next to their originals (admitted
    in one wave, so the pairs share blocks), then two more (64 to 512
    tokens at full size)."""
    cfg = cst.config(size)
    rng = np.random.default_rng(0)
    if size == "smoke":
        base = [rng.integers(1, cfg.vocab_size, int(rng.integers(5, 20)))
                .astype(np.int32) for _ in range(4)]
    else:
        base = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
                for n in (100, 64, 300, 512)]
    return [base[0], base[0].copy(), base[1], base[1].copy(), base[2], base[3]]


def requests(size: str) -> list:
    from repro_torch.serve import Request

    return [Request(rid=i, prompt=p, max_new_tokens=PAGED[size][3])
            for i, p in enumerate(prompts(size))]


def drive(engine, reqs) -> dict:
    for r in reqs:
        engine.submit(r)
    engine.run()
    return {r.rid: list(r.out) for r in reqs}


def engines(model, size: str, rules=None, device="cuda") -> dict:
    from repro_torch.serve import (PagedServeConfig, PagedServingEngine,
                                   ServeConfig, ServingEngine)

    B, S = cst.SIZES[size][:2]
    bt, nb, chunk, _ = PAGED[size]
    pcfg = dict(max_batch=B, max_seq=S, block_tokens=bt, n_blocks=nb)
    return {"dense": ServingEngine(model, ServeConfig(max_batch=B, max_seq=S),
                                   rules=rules, device=device),
            "paged": PagedServingEngine(model, PagedServeConfig(**pcfg),
                                        rules=rules, device=device),
            "chunked": PagedServingEngine(model, PagedServeConfig(**pcfg, chunk=chunk),
                                          rules=rules, device=device)}


def run(model, size: str, rules=None, device="cuda", mesh=None) -> dict:
    """The three engines driven in turn (streams, logit logs, block reuse,
    hygiene, timing, readings and kernel calls against ``serve_launches``),
    then the router over two fresh paged engines."""
    from repro_torch.kernels import ops
    from repro_torch.params import tree_leaves
    from repro_torch.serve import PrefixRouter
    from repro_torch.testing.check_dist_train import counting
    from repro_torch.testing.subproc import readings
    from repro_torch.train.trainer import serve_launches

    out = {}
    dev = torch.device(device)
    for tag, eng in engines(model, size, rules, device).items():
        eng.logit_log = []
        reqs = requests(size)
        ops.reset_launches()
        with counting() as counts, (readings(mesh, dev) if mesh is not None
                                    else contextlib.nullcontext({})) as st:
            streams = drive(eng, reqs)
        calls = dict(ops.LAUNCHES) if dev.type == "cuda" else counts
        keys = ops.LAUNCHES if dev.type == "cuda" else counts
        t = eng.timing
        if tag == "dense":
            want = serve_launches(eng.cfg, len(reqs), t["decode_steps"], rules=rules)
        else:
            want = serve_launches(eng.cfg, t["prefills"], t["decode_steps"],
                                  chunks=t["chunks"], paged=True, rules=rules)
        rec = {"streams": streams, "logits": eng.logit_log, "timing": dict(t),
               "ttft_ms": [1e3 * (r.t_first - r.t_submit) for r in reqs],
               "stats": dict(st), "launches": ({k: calls[k] for k in keys},
                                               {k: want[k] for k in keys})}
        if tag != "dense":
            eng.shutdown()                   # the free list, refcounts, registry
            rec.update(shared_hits=eng.alloc.shared_hits, cow_copies=eng.cow_copies,
                       peak_blocks=eng.alloc.peak_allocated,
                       zero_block_zero=all(bool((leaf[:, 0] == 0).all())
                                           for leaf in tree_leaves(eng.pool)),
                       pool_axes={a for s in tree_leaves(eng.pool_specs)
                                  for d in s for a in d})
        out[tag] = rec
    pe = engines(model, size, rules, device)
    router = PrefixRouter([pe["paged"], engines(model, size, rules, device)["paged"]])
    stream = requests(size)
    first = router.submit(stream[0])
    router.run()
    for r in stream[2:]:
        router.submit(r)
    router.run()
    dup = router.submit(stream[1])
    router.run()
    out["router"] = {"first": first, "dup": dup, "affinity_hits": router.affinity_hits}
    return out


def rank_main(args) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import place_tree
    from repro_torch.testing.subproc import join

    with join(args) as world:
        mesh = make_mesh(world, cst.MESH, cst.NAMES)
        cfg = cst.config(args.size)
        rules = cst.rules_for(mesh, cfg, args.size)
        model = lm.Model(cfg, place_tree(cst.weights(args.size, world.device),
                                         lm.model_defs(cfg), rules))
        res = run(model, args.size, rules, world.device, mesh)
        if world.rank:
            for r in res.values():
                r.pop("logits", None)
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def check(ranks: list, strict: bool = True) -> dict:
    """The reference's assertions on every rank's results; returns rank
    0's with the dense-vs-paged and dense-vs-chunked logit limit uses.  Not
    ``strict`` (bf16 on the card) the engines' streams and logits against
    the dense one are measured (``check_serve_topology.agreement``), not
    asserted."""
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        for tag in ("dense", "paged", "chunked"):
            assert res[tag]["streams"] == r0[tag]["streams"], (r, tag)
            assert not strict or res[tag]["streams"] == r0["dense"]["streams"], (r, tag)
            got, want = res[tag]["launches"]
            assert got == want, (r, tag, got, want)
        for tag in ("paged", "chunked"):
            assert res[tag]["zero_block_zero"], f"rank {r}: {tag}'s zero block written"
            assert "pod" not in res[tag]["pool_axes"], res[tag]["pool_axes"]
        p = res["paged"]
        assert p["shared_hits"] >= 1, "no shared-prefix block reuse"
        assert p["cow_copies"] >= 1, "no COW copy despite shared full blocks"
        assert res["chunked"]["timing"]["chunks"] > 0, "chunked engine never chunked"
        rt = res["router"]
        assert rt["dup"] == rt["first"] and rt["affinity_hits"] >= 1, rt
    if not strict:
        return {**r0, "vs_dense": {
            tag: cst.agreement(r0[tag]["streams"], r0["dense"]["streams"],
                               r0[tag]["logits"], r0["dense"]["logits"])
            for tag in ("paged", "chunked")}}
    use = {tag: cst.logit_use(r0[tag]["logits"], r0["dense"]["logits"])
           for tag in ("paged", "chunked")}
    assert max(use.values()) <= 1.0, f"paged logits part from dense: {use}"
    return {**r0, "limit_use_vs_dense": use}


def main(argv=None) -> dict:
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("paged-KV serving on a (2, 2, 2) mesh of 8 ranks")
    ap.add_argument("--size", choices=tuple(PAGED), default="smoke")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    d = run_ranks("repro_torch.testing.check_serve_paged", RANKS, "--size",
                  args.size, device=args.device, workdir=args.dir, timeout=900)
    out = check(cst.assemble(d))
    p = out["paged"]
    print(f"check_serve_paged OK (mesh 2x2x2, {RANKS} ranks on {args.device}; "
          f"shared_hits={p['shared_hits']} cow_copies={p['cow_copies']} "
          f"peak_blocks={p['peak_blocks']} prefill_chunks="
          f"{out['chunked']['timing']['chunks']}; pool cut over "
          f"{sorted(p['pool_axes'])}; logits vs dense limit use "
          f"{out['limit_use_vs_dense']})")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
