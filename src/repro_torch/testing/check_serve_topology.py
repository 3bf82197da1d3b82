"""Distributed check: pod-local KV serving on a (2, 2, 2) (pod, data, model)
mesh of 8 ranks.

The port's twin of ``repro.testing.check_serve_topology``.  Two
``ServingEngine`` s run the same request stream with the same rules on
the same mesh, one topology-blind, one with the three-level ``Topology``;
every rank runs both (``testing.subproc.run_ranks``).  Asserted, as the
reference asserts:

  1. *placement*: no cache leaf of the topology engine is cut over `pod`,
     at construction and after the loop (each leaf's block has the shape
     its placement gives), and `data` and `model` do cut it;
  2. *affinity*: phase 1's three prompts land first-free in slots 0-2; the
     repeat of r2's prefix lands in pod 1 (r2's) in the topology engine,
     in slot 0 in the blind one;
  3. *the same tokens*: the two engines' streams are equal request by
     request.  The topology engine decodes a rank's 2 of the 4 slots (the
     slots cut over `data`); where a product over fewer rows rounds
     otherwise, the logits of the two engines are held within
     ``check_dist_decode``'s f32 limits (``RTOL``, ``ATOL``), the streams
     still equal.

Each engine's greedy logits are kept (``logit_log``), with each rank's
kernel calls (the calls of the kernels' Functions on the CPU, ``ops``'
launch counters on the card) against ``trainer.serve_launches``.
``tests/test_torch_serve_mesh.py`` also holds the streams to the JAX
package's single-device engine; ``chip_smoke.py`` (phase 13, ``--size
full``) runs llama3-8b at its published width, 1 of 32 layers, with 8
ranks on one card and holds the logits to the same engines in one process.

    PYTHONPATH=src python -m repro_torch.testing.check_serve_topology --device cpu
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np
import torch

MESH, NAMES = (2, 2, 2), ("pod", "data", "model")
RANKS = 8
ARCH = "llama3-8b"
#: the full size's cut: 1 of llama3-8b's 32 layers
FULL_LAYERS = 1
#: (max_batch, max_seq, new tokens a request, prompt lengths)
SIZES = {"smoke": (4, 64, 6, (4, 12)), "full": (4, 640, 16, (64, 512))}
#: f32 on both sides, sums over other row counts (``check_dist_decode``'s)
RTOL = ATOL = 1e-5


def config(size: str):
    from repro_torch.configs import get_config, get_smoke_config

    if size == "smoke":
        return get_smoke_config(ARCH)
    return dataclasses.replace(get_config(ARCH), n_layers=FULL_LAYERS)


def topology():
    from repro_torch.topology import Topology

    return Topology.from_levels([("pod", 2, 8.0), ("data", 2, 4.0), ("model", 2, 2.0)])


def rules_for(mesh, cfg, size: str = "smoke"):
    """The reference's serving rules: the batch whole (the admit loop
    prefills one request at a time), TP over `model`, the kv heads cut
    where they divide, ZeRO-3 over (pod, data).  At full size the weights
    stay whole over (pod, data) (``fsdp=False``): ranks that share one card
    through host buffers would copy every layer's weights through the host
    at every decode step."""
    from repro_torch.parallel.sharding import default_rules

    return default_rules(mesh, kv_heads=cfg.n_kv_heads, batch=1,
                         fsdp=size == "smoke")


def weights(size: str, device) -> dict:
    """The whole tree: the JAX initialiser's smoke weights (key 0), or at
    the published width a seeded draw on ``device``."""
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.testing import train_checks as tc

    if size == "smoke":
        return tree_map(lambda t: t.to(device), tc.smoke_params(ARCH))
    return init_params(lm.model_defs(config(size)),
                       torch.Generator(device).manual_seed(0), device)


def prompts(size: str) -> list:
    """Three distinct prompts and a repeat of the third (the reference's
    draw at smoke size; 64 to 512 tokens at full size)."""
    cfg = config(size)
    lo, hi = SIZES[size][3]
    rng = np.random.default_rng(0)
    if size == "smoke":
        ps = [rng.integers(1, cfg.vocab_size, int(rng.integers(lo, hi)))
              .astype(np.int32) for _ in range(3)]
    else:
        ps = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
              for n in (lo, 200, hi)]
    return ps + [ps[2].copy()]               # r3 repeats r2's prefix


def requests(size: str) -> list:
    from repro_torch.serve import Request

    return [Request(rid=i, prompt=p, max_new_tokens=SIZES[size][2])
            for i, p in enumerate(prompts(size))]


def drive(engine, reqs) -> dict:
    """The reference's two phases: three distinct prompts fill slots 0-2;
    then, every slot free again, r3 repeats r2's prefix."""
    for r in reqs[:3]:
        engine.submit(r)
    engine.run()
    engine.submit(reqs[3])
    engine.run()
    return {r.rid: (r.slot, list(r.out)) for r in reqs}


def cache_axes(engine) -> set:
    """Every mesh dimension that cuts a leaf of the engine's cache."""
    from repro_torch.params import tree_leaves

    return {a for spec in tree_leaves(engine.cache_specs) for d in spec for a in d}


def assert_pod_local(engine, when: str) -> set:
    """No cache leaf cut over `pod`, and each leaf the shape its placement
    gives on this rank; returns the dimensions that cut the cache."""
    from repro_torch.params import tree_leaves
    from repro_torch.parallel.sharding import local_shape

    axes = cache_axes(engine)
    assert "pod" not in axes, f"cache cut across the pod ring {when}: {axes}"
    mesh = engine.mesh
    if mesh is not None:
        for t, spec in zip(tree_leaves(engine.cache), tree_leaves(engine.cache_specs)):
            full = tuple(n * (mesh.axis_size(d) if d else 1)
                         for n, d in zip(t.shape, spec))
            assert tuple(t.shape) == local_shape(full, spec, mesh), (when, t.shape, spec)
    return axes


def engines(model, size: str, rules=None, device="cuda") -> dict:
    """The blind and the topology engine over ``model`` (whole weights, or
    this rank's blocks under ``rules``)."""
    from repro_torch.serve import ServeConfig, ServingEngine

    B, S, *_ = SIZES[size]
    scfg = ServeConfig(max_batch=B, max_seq=S)
    return {"blind": ServingEngine(model, scfg, rules=rules, device=device),
            "aware": ServingEngine(model, scfg, rules=rules, topology=topology(),
                                   device=device)}


def run(model, size: str, rules=None, device="cuda", mesh=None) -> dict:
    """Both engines driven in turn: streams, logit logs, the dimensions
    that cut the cache (at construction and after), each engine's timing,
    its readings (``subproc.readings``, under a mesh) and kernel calls
    against ``serve_launches``."""
    from repro_torch.kernels import ops
    from repro_torch.testing.check_dist_train import counting
    from repro_torch.testing.subproc import readings
    from repro_torch.train.trainer import serve_launches

    out = {}
    dev = torch.device(device)
    for tag, eng in engines(model, size, rules, device).items():
        eng.logit_log = []
        before = assert_pod_local(eng, "at construction")
        reqs = requests(size)
        ops.reset_launches()
        with counting() as counts, (readings(mesh, dev) if mesh is not None
                                    else contextlib.nullcontext({})) as st:
            streams = drive(eng, reqs)
        calls = dict(ops.LAUNCHES) if dev.type == "cuda" else counts
        want = serve_launches(eng.cfg, len(reqs), eng.timing["decode_steps"],
                              rules=rules)
        keys = ops.LAUNCHES if dev.type == "cuda" else counts
        out[tag] = {"streams": streams, "logits": eng.logit_log,
                    "ttft_ms": [1e3 * (r.t_first - r.t_submit) for r in reqs],
                    "axes": (before, assert_pod_local(eng, "after the decode loop")),
                    "n_pods": eng.n_pods, "timing": dict(eng.timing),
                    "stats": dict(st), "slot_rows": (eng.slot_rows.start,
                                                     eng.slot_rows.stop),
                    "launches": ({k: calls[k] for k in keys},
                                 {k: want[k] for k in keys})}
    return out


def rank_main(args) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import place_tree
    from repro_torch.testing.subproc import join

    with join(args) as world:
        mesh = make_mesh(world, MESH, NAMES)
        cfg = config(args.size)
        rules = rules_for(mesh, cfg, args.size)
        model = lm.Model(cfg, place_tree(weights(args.size, world.device),
                                         lm.model_defs(cfg), rules))
        res = run(model, args.size, rules, world.device, mesh)
        if world.rank:                       # rank 0 keeps the logit logs
            for r in res.values():
                r["logits"] = None
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def assemble(d) -> list:
    return [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(RANKS)]


def by_request(log: list) -> dict:
    """A logit log as {rid: (picks, V)}: each request's greedy picks'
    logits in order (its prefill's, then its decode steps')."""
    out: dict = {}
    for kind, ids, t in log:
        rows = [(ids, t)] if kind == "prefill" else zip(ids, t)
        for rid, row in rows:
            out.setdefault(rid, []).append(row.float())
    return {rid: torch.stack(v) for rid, v in out.items()}


def agreement(got: dict, want: dict, got_log: list, want_log: list) -> dict:
    """Two runs of the same requests: the share of greedy picks that agree,
    and over the picks up to each request's first disagreement (their
    inputs are the same) the largest |d| over the pick's largest |logit|."""
    g, w = by_request(got_log), by_request(want_log)
    same = total = 0
    share = 0.0
    for rid, want_toks in want.items():
        got_toks = got[rid][1] if isinstance(got[rid], tuple) else got[rid]
        want_toks = want_toks[1] if isinstance(want_toks, tuple) else want_toks
        n = 0
        while n < min(len(got_toks), len(want_toks)) and got_toks[n] == want_toks[n]:
            n += 1
        same += n
        total += len(want_toks)
        k = min(n + 1, len(g[rid]), len(w[rid]))
        d = (g[rid][:k] - w[rid][:k]).abs().amax(dim=-1)
        share = max(share, float((d / w[rid][:k].abs().amax(dim=-1)).max()))
    return {"agree": same / max(total, 1), "share": share}


def logit_use(got: list, want: list) -> float:
    """The largest |d| / (ATOL + RTOL |want|) over two logit logs of the
    same requests, pick by pick."""
    g, w = by_request(got), by_request(want)
    assert g.keys() == w.keys() and all(g[k].shape == w[k].shape for k in g)
    return max(float(((g[k] - w[k]).abs() / (ATOL + RTOL * w[k].abs())).max())
               for k in g)


def check(ranks: list, strict: bool = True) -> dict:
    """The reference's assertions on every rank's results; returns rank
    0's with the blind-vs-aware logit limit use.  Not ``strict`` (bf16 on
    the card) the two engines' streams and logits are measured
    (``agreement``), not asserted."""
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        b, a = res["blind"], res["aware"]
        assert a["n_pods"] == 2, a["n_pods"]
        for when in a["axes"]:
            assert "pod" not in when and {"data", "model"} <= when, (r, when)
        assert b["streams"] == r0["blind"]["streams"], f"rank {r}'s blind streams"
        assert a["streams"] == r0["aware"]["streams"], f"rank {r}'s aware streams"
        for tag in ("blind", "aware"):
            got, want = res[tag]["launches"]
            assert got == want, (r, tag, got, want)
    gb, ga = r0["blind"]["streams"], r0["aware"]["streams"]
    assert [ga[i][0] for i in range(3)] == [0, 1, 2], ga
    assert gb[3][0] == 0, gb[3]
    assert ga[3][0] * 2 // 4 == 1, ga[3]         # slot_pod: pod 1 holds slots 2, 3
    if not strict:
        return {**r0, "blind_vs_aware": agreement(ga, gb, r0["aware"]["logits"],
                                                  r0["blind"]["logits"])}
    for rid in gb:
        assert gb[rid][1] == ga[rid][1], (rid, gb[rid][1], ga[rid][1])
    use = logit_use(r0["aware"]["logits"], r0["blind"]["logits"])
    assert use <= 1.0, f"blind and aware logits part beyond f32's limits: {use}"
    return {**r0, "blind_vs_aware_limit_use": use}


def main(argv=None) -> dict:
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("pod-local KV serving on a (2, 2, 2) mesh of 8 ranks")
    ap.add_argument("--size", choices=tuple(SIZES), default="smoke")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    d = run_ranks("repro_torch.testing.check_serve_topology", RANKS, "--size",
                  args.size, device=args.device, workdir=args.dir, timeout=900)
    out = check(assemble(d))
    print(f"check_serve_topology OK (mesh 2x2x2, {RANKS} ranks on {args.device}; "
          f"pod-local cache axes {sorted(out['aware']['axes'][1])}; repeat of r2 "
          f"in slot {out['aware']['streams'][3][0]} (blind: "
          f"{out['blind']['streams'][3][0]}); blind vs aware logits limit use "
          f"{out['blind_vs_aware_limit_use']:.3g})")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
