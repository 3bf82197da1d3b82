"""Distributed check: the Mamba2 and cross-attention sublayers on a process
mesh, and a whole ``forward_train`` of each of their families.

    PYTHONPATH=src python -m repro_torch.testing.check_dist_families 1 4 --device cpu

runs nd x nm ranks (gloo on the CPU).  For each arch of ``ARCHS`` at smoke
size, from the JAX initialiser's weights (``train_checks.smoke_params``):

* its first Mamba2 sublayer (mamba2-370m, jamba) or cross-attention
  sublayer (llama-3.2-vision-11b, seamless-m4t-large-v2), the heads cut
  over `model`: the prefill's output and the cache it leaves (each rank's
  block), a decode step's output and cache, and the gradient of a fixed
  linear function of the prefill's output with respect to every parameter
  and the inputs (x, and the context);
* ``forward_train``'s loss and every gradient leaf (summed by the
  gradient sync) on ``train_checks``' first batch (and context), with the
  batch cut over the data dimensions.

The launcher gathers the blocks (``gather_tree``) and holds them to the
same calls in one process (``SUB_TOL``: the limit the tests hold the JAX
layer to; ``train_checks.compare_runs``' gradient limits for the whole
model).  ``tests/test_torch_dist_families.py`` holds them to the JAX
package.  ``--size full`` runs the sublayers alone, no gradient, at the
published widths of ``FULL_ARCHS`` (bf16, seeded weights, ``FULL_DIMS``)
and returns them gathered: ``chip_smoke.py`` (phase 13 b, c) holds them to
one process on the card.  Imports only the port.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

ARCHS = ("mamba2-370m", "jamba-1.5-large-398b", "llama-3.2-vision-11b",
         "seamless-m4t-large-v2")
#: the sublayer each arch's check takes: (layer, slot key), period 0
SLOT = {"mamba2-370m": ("l0", "s0_mamba"), "jamba-1.5-large-398b": ("l0", "s0_mamba"),
        "llama-3.2-vision-11b": ("l2", "s0_xattn"),
        "seamless-m4t-large-v2": ("l0", "s1_xattn")}
#: the sublayer's inputs: batch, prefill tokens, context tokens
B, S, T = 2, 16, 16
#: ``--size full``: the archs, and their sublayer's (B, S, T): a Mamba2
#: prefill of two 256-token chunks, a cross-attention prefill against
#: llama-3.2-vision-11b's 6,404 image tokens
FULL_ARCHS = ("mamba2-370m", "llama-3.2-vision-11b")
FULL_DIMS = {"mamba2-370m": (2, 512, 16), "llama-3.2-vision-11b": (2, 128, 6404)}
#: |d| <= SUB_TOL (|want| + max|want|) for the sublayers' outputs, caches
#: and gradients (the limit the MoE sublayer's mesh check holds to JAX)
SUB_TOL = 2e-4


def config(arch: str, size: str = "smoke"):
    from repro_torch.configs import get_config, get_smoke_config

    return get_smoke_config(arch) if size == "smoke" else get_config(arch)


def dims(arch: str, size: str = "smoke") -> tuple:
    return (B, S, T) if size == "smoke" else FULL_DIMS[arch]


def sublayer_rules(mesh, cfg):
    """The sublayer checks' rules: every rank runs every row (batch 1 does
    not divide, so the batch stays whole), the weights whole over `data`
    (no ZeRO-3: a sublayer call gathers nothing), the heads over `model`."""
    from repro_torch.parallel.sharding import default_rules

    return default_rules(mesh, kv_heads=cfg.n_kv_heads, fsdp=False, batch=1)


def is_mamba(arch: str) -> bool:
    return SLOT[arch][1].endswith("mamba")


def inputs(arch: str, size: str = "smoke") -> dict:
    """x (B, S, d), the decode token's x (B, 1, d), the context (B, T, d)
    and the weights w of the loss sum(w * out), f32 numpy from seed 0."""
    cfg = config(arch, size)
    b, s, t = dims(arch, size)
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return {"x": f(b, s, cfg.d_model), "x1": f(b, 1, cfg.d_model),
            "ctx": f(b, t, cfg.d_model), "w": f(b, s, cfg.d_model)}


def slot_params(arch: str, device, size: str = "smoke") -> dict:
    """The sublayer's whole params: period 0 of the smoke weights, or at
    the published width a seeded draw on ``device``."""
    from repro_torch.params import init_params
    from repro_torch.testing import train_checks as tc

    if size == "full":
        return init_params(slot_defs(arch, size),
                           torch.Generator(device).manual_seed(0), device)
    li, key = SLOT[arch]
    return {k: t[0].to(device) for k, t in tc.smoke_params(arch)["period"][li][key].items()}


def slot_defs(arch: str, size: str = "smoke") -> dict:
    from repro_torch.models import layers as L

    cfg = config(arch, size)
    return L.mamba_defs(cfg) if is_mamba(arch) else L.xattn_defs(cfg)


def cache_defs(arch: str, size: str = "smoke") -> dict:
    from repro_torch.models import layers as L
    from repro_torch.params import PV

    cfg = config(arch, size)
    b, _, t = dims(arch, size)
    if is_mamba(arch):
        return L.mamba_cache_defs(cfg, b)._asdict()
    shp = (b, t, cfg.n_kv_heads, cfg.head_dim)
    return {k: PV(shp, cfg.dtype, ("batch", "", "kv", "")) for k in ("k", "v")}


def sublayer(arch: str, params: dict, ins: dict, rules=None, device="cpu",
             size: str = "smoke") -> dict:
    """The prefill (output and cache), a decode step (output and cache),
    and (at smoke size) the gradients of sum(w * prefill output) (params,
    x, ctx).  The inputs are cast to the model's dtype."""
    from repro_torch.models import layers as L

    cfg = config(arch, size)
    t = {k: torch.from_numpy(v).to(device, cfg.dtype) for k, v in ins.items()}
    if size == "full":
        with torch.no_grad():
            return _forward(arch, cfg, params, t, rules)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    x = t["x"].requires_grad_(True)
    ctx = t["ctx"].requires_grad_(True)
    if is_mamba(arch):
        out, (conv, state) = L.mamba_layer(p, x, cfg, return_state=True, rules=rules)
        cache = {"conv": conv, "state": state}
    else:
        out, c = L.xattn_layer_prefill(p, x, ctx, cfg, rules=rules)
        cache = c._asdict()
    leaves = list(p.values()) + [x] + ([] if is_mamba(arch) else [ctx])
    grads = torch.autograd.grad(torch.sum(out * t["w"]), leaves)
    cache = {k: v.detach().clone() for k, v in cache.items()}
    with torch.no_grad():
        pd = {k: v.detach() for k, v in p.items()}
        if is_mamba(arch):
            c1 = L.MambaCache(**{k: v.clone() for k, v in cache.items()})
            out1, c1 = L.mamba_layer_decode(pd, t["x1"], c1, cfg, rules=rules)
        else:
            out1, c1 = L.xattn_layer_decode(pd, t["x1"], L.XAttnCache(**cache), cfg,
                                            rules=rules)
    return {"out": out.detach().cpu(), "cache": {k: v.cpu() for k, v in cache.items()},
            "out1": out1.cpu(), "cache1": {k: v.cpu() for k, v in c1._asdict().items()},
            "grads": {k: g.cpu() for k, g in zip(list(p) + ["x", "ctx"], grads)}}


def _forward(arch, cfg, p, t, rules) -> dict:
    """The prefill and a decode step, no gradient (``--size full``)."""
    from repro_torch.models import layers as L

    if is_mamba(arch):
        out, (conv, state) = L.mamba_layer(p, t["x"], cfg, return_state=True, rules=rules)
        cache = {"conv": conv, "state": state}
        c = L.MambaCache(**{k: v.clone() for k, v in cache.items()})
        out1, c1 = L.mamba_layer_decode(p, t["x1"], c, cfg, rules=rules)
    else:
        out, c = L.xattn_layer_prefill(p, t["x"], t["ctx"], cfg, rules=rules)
        cache = c._asdict()
        out1, c1 = L.xattn_layer_decode(p, t["x1"], c, cfg, rules=rules)
    return {"out": out.cpu(), "cache": {k: v.cpu() for k, v in cache.items()},
            "out1": out1.cpu(), "cache1": {k: v.cpu() for k, v in c1._asdict().items()}}


def train_inputs(arch: str) -> tuple:
    """``train_checks``' first smoke batch (4 x 32) and its context (or
    None), as tensors."""
    from repro_torch.testing import train_checks as tc

    toks = torch.from_numpy(tc.smoke_batches(1, arch=arch)[0]).long()
    ctx = tc.smoke_contexts(1, arch=arch)[0]
    return toks, None if ctx is None else torch.from_numpy(ctx)


def forward_train(arch: str, params: dict, rules=None, rows=None, device="cpu"):
    """(loss, the gradient tree) of ``lm.forward_train`` on this rank's rows
    (the gradient summed by the gradient sync under a mesh)."""
    from repro_torch.params import tree_leaves, tree_unflatten
    from repro_torch.train.trainer import loss_and_grads, make_grad_sync, trainable

    cfg = config(arch)
    toks, ctx = train_inputs(arch)
    cut = rows or (lambda t: t)
    p = trainable(params)
    loss, g = loss_and_grads(p, cut(toks).to(device), cfg,
                             None if ctx is None else cut(ctx).to(device), rules)
    if rules is not None:
        g = tree_unflatten(p, make_grad_sync(cfg, rules).reduce(tree_leaves(g)))
    return float(loss), g


def rank_main(args) -> None:
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.params import tree_map
    from repro_torch.parallel.sharding import block, default_rules, shard_tree
    from repro_torch.testing import train_checks as tc
    from repro_torch.testing.subproc import join

    with join(args) as world:
        dev = world.device
        mesh = make_debug_mesh(world, *args.mesh)
        res = {"mesh": args.mesh, "sub": {}, "train": {}, "stats": {}}
        if args.size == "full":
            from repro_torch.testing.subproc import readings

            for arch in FULL_ARCHS:
                rules = sublayer_rules(mesh, config(arch, "full"))
                p = shard_tree(slot_params(arch, dev, "full"), slot_defs(arch, "full"),
                               rules, mesh.rank)
                with readings(mesh, dev) as st:
                    res["sub"][arch] = sublayer(arch, p, inputs(arch, "full"), rules,
                                                dev, "full")
                res["stats"][arch] = st
                del p
            torch.save(res, f"{args.dir}/rank{world.rank}.pt")
            return
        for arch in ARCHS:
            cfg = config(arch)
            rules = sublayer_rules(mesh, cfg)
            p = shard_tree(slot_params(arch, dev), slot_defs(arch), rules, mesh.rank)
            res["sub"][arch] = sublayer(arch, p, inputs(arch), rules, dev)
            toks, _ = train_inputs(arch)
            trules = default_rules(mesh, batch=toks.shape[0])
            spec = lambda t: trules.spec(("batch",) + ("",) * (t.ndim - 1))
            whole = tree_map(lambda t: t.to(dev), tc.smoke_params(arch))
            loss, g = forward_train(arch, shard_tree(whole, lm.model_defs(cfg), trules,
                                                     mesh.rank), trules,
                                    lambda t: block(t, spec(t), mesh, mesh.rank), dev)
            res["train"][arch] = {"loss": loss, "grads": tree_map(lambda t: t.cpu(), g)}
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def assemble_full(d, world: int) -> dict:
    """``--size full``: per arch the sublayer's whole results (outputs and
    caches gathered from the ranks' blocks) and each rank's readings."""
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import gather_tree

    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]
    mesh = Mesh.abstract(ranks[0]["mesh"], ("data", "model"))
    out = {}
    for arch in FULL_ARCHS:
        rules = sublayer_rules(mesh, config(arch, "full"))
        subs = [r["sub"][arch] for r in ranks]
        cdefs = cache_defs(arch, "full")
        out[arch] = {"out": subs[0]["out"], "out1": subs[0]["out1"],
                     "same_out_on_every_rank": all(
                         torch.equal(s["out"], subs[0]["out"]) for s in subs),
                     "cache": gather_tree([s["cache"] for s in subs], cdefs, rules),
                     "cache1": gather_tree([s["cache1"] for s in subs], cdefs, rules),
                     "stats": [r["stats"][arch] for r in ranks]}
    return out


def assemble(d, world: int) -> dict:
    """Per arch: the sublayer's whole results and the whole-model loss and
    gradient tree, from every rank's blocks."""
    from repro_torch.models import lm
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules, gather_tree
    from repro_torch.params import PV

    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(world)]
    mesh = Mesh.abstract(ranks[0]["mesh"], ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = config(arch)
        rules = sublayer_rules(mesh, cfg)
        subs = [r["sub"][arch] for r in ranks]
        gdefs = {**slot_defs(arch),
                 "x": PV((B, S, cfg.d_model), torch.float32, ("", "", "")),
                 "ctx": PV((B, T, cfg.d_model), torch.float32, ("", "", ""))}
        gdefs = {k: gdefs[k] for k in subs[0]["grads"]}
        cdefs = cache_defs(arch)
        toks, _ = train_inputs(arch)
        trules = default_rules(mesh, batch=toks.shape[0])
        out[arch] = {
            "out": subs[0]["out"], "out1": subs[0]["out1"],
            "same_out_on_every_rank": all(torch.equal(s["out"], subs[0]["out"])
                                          and torch.equal(s["out1"], subs[0]["out1"])
                                          for s in subs),
            "cache": gather_tree([s["cache"] for s in subs], cdefs, rules),
            "cache1": gather_tree([s["cache1"] for s in subs], cdefs, rules),
            "grads": gather_tree([s["grads"] for s in subs], gdefs, rules),
            "loss": [r["train"][arch]["loss"] for r in ranks],
            "train_grads": gather_tree([r["train"][arch]["grads"] for r in ranks],
                                       lm.model_defs(cfg), trules)}
    return out


def expected(arch: str) -> dict:
    """One process's sublayer calls and forward_train, on the CPU."""
    from repro_torch.params import tree_map
    from repro_torch.testing import train_checks as tc

    out = sublayer(arch, slot_params(arch, "cpu"), inputs(arch))
    loss, g = forward_train(arch, tree_map(lambda t: t.clone(), tc.smoke_params(arch)))
    return {**out, "loss": [loss], "train_grads": g}


def limit_use(got: torch.Tensor, want: torch.Tensor, tol: float = SUB_TOL) -> float:
    """max |d| / (tol (|want| + max|want|))."""
    got, want = got.float(), want.float()
    lim = tol * (want.abs() + want.abs().max())
    return float(((got - want).abs() / lim.clamp_min(1e-30)).max())


def _by_path(t) -> dict:
    """{dotted path: leaf} of a tensor or a nested dict of them."""
    from repro_torch.testing.check_dist_train import flat

    return flat(t) if isinstance(t, dict) else {"": t}


def main(argv=None) -> dict:
    from repro_torch.testing import train_checks as tc
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("the Mamba2 and cross-attention families on a process mesh")
    ap.add_argument("nd", type=int, nargs="?", default=1)
    ap.add_argument("nm", type=int, nargs="?", default=2)
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke")
    args = ap.parse_args(argv)
    args.mesh = (args.nd, args.nm)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    world = args.nd * args.nm
    d = run_ranks("repro_torch.testing.check_dist_families", world, str(args.nd),
                  str(args.nm), "--size", args.size, device=args.device,
                  workdir=args.dir, timeout=600)
    if args.size == "full":
        return assemble_full(d, world)
    got = assemble(d, world)
    worst = 0.0
    for arch in ARCHS:
        g, w = got[arch], expected(arch)
        use = {}
        for k in ("out", "out1", "cache", "cache1", "grads"):
            a, b = _by_path(g[k]), _by_path(w[k])
            assert a.keys() == b.keys(), (arch, k)
            use[k] = max(limit_use(a[p], b[p]) for p in a)
        rtol, atol = tc.START_ONLY.get(arch, tc.GRAD_TOL)
        a, b = _by_path(g["train_grads"]), _by_path(w["train_grads"])
        assert a.keys() == b.keys(), arch
        tg = max(float(((a[p] - b[p]).abs()
                        / (rtol * b[p].abs() + atol * b[p].abs().max())
                        .clamp_min(1e-30)).max()) for p in a)
        loss = max(abs(x - w["loss"][0]) / abs(w["loss"][0]) for x in g["loss"])
        ok = (max(use.values()) <= 1.0 and tg <= 1.0 and loss <= tc.SCALAR_RTOL
              and g["same_out_on_every_rank"])
        worst = max(worst, 0.0 if ok else float("inf"))
        print(f"check_dist_families {arch} mesh {args.nd}x{args.nm}: sublayer limit use "
              f"{ {k: round(v, 4) for k, v in use.items()} } (SUB_TOL {SUB_TOL}); "
              f"forward_train loss rel {loss:.2e}, gradient limit use {tg:.3f}")
    if worst > 1.0:
        raise AssertionError("check_dist_families failed")
    print(f"check_dist_families OK (mesh {args.nd}x{args.nm})")
    return got


if __name__ == "__main__":
    main(sys.argv[1:])
