"""Distributed check: the sharded train step (tensor-, expert- and
data-parallel layers, the vocab-parallel loss, ZeRO-3 over the ``fsdp``
rule, the gradient sync and the mesh's gradient norm).

    PYTHONPATH=src python -m repro_torch.testing.check_dist_train 2 2 --device cpu

runs 4 ranks on the CPU (gloo) for llama3-8b's smoke model (kv 2: a
`model` of 4 cuts through heads) and mixtral's (its MoE sublayers in ep
mode) from the JAX initialiser's weights (``train_checks``): the loss and
the gradient at the start (summed by the unbucketed sync), then three
``make_train_step`` steps with 1 and 2 microbatches, unbucketed and
bucketed (``BUCKET_MB``: several buckets), and one counted step (the calls
of the kernels' Functions, which launch the kernels on the card, against
``trainer.step_launches``).  The launcher (:func:`main`) gathers the
ranks' blocks (``gather_tree``) and holds the runs to one process's
(``train_checks.compare_runs``); ``tests/test_torch_dist_train.py`` holds
them to the JAX package's ``jax.grad`` and train steps.  ``chip_smoke.py``
runs llama3-8b at its published width (``--size full``: 1 of 32 layers,
4 x 1024 tokens, remat) with four ranks on one card.  Imports only the
port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import torch

#: a bucket of at most 1 KiB: each of the smoke models' replicated leaves
#: (a 64-wide norm is 256 bytes) closes several buckets
BUCKET_MB = 2**-10
#: the smoke runs: steps, batch, sequence, microbatch counts
STEPS, BATCH, SEQ = 3, 4, 32
MICRO = (1, 2)
SMOKE_ARCHS = ("llama3-8b", "mixtral-8x7b")
#: the full run: llama3-8b at its published width, 1 of its 32 layers
FULL_LAYERS, FULL_BATCH, FULL_SEQ = 1, 4, 1024
#: the leaves whose step-1 gradient (summed over the mesh) the full run
#: brings back: one of each kind of cut (vocab over `model`; d_model over
#: the data dimensions and heads or d_ff over `model`; whole)
FULL_LEAVES = ("embed", "head", "final_norm", "period.l0.s0_attn.wq",
               "period.l0.s0_attn.wk", "period.l0.s0_attn.wo",
               "period.l0.s1_mlp.wi", "period.l0.s1_mlp.wo",
               "period.l0.s1_mlp.norm")
#: ... as a strided sample of each rank's block of at most this many
#: elements (every element of a small leaf)
SAMPLE = 2**20


def sample(t: torch.Tensor) -> torch.Tensor:
    """Every s-th element of t, flattened, s = numel // SAMPLE (at least 1)."""
    return t.reshape(-1)[::max(1, t.numel() // SAMPLE)].clone()


def flat(tree: dict, pre: str = "") -> dict:
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{pre}.{k}" if pre else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def leaf_norms(grads: dict, defs: dict, rules=None) -> dict:
    """{dotted path: the leaf's whole L2 norm}: this rank's sum of squares
    summed over the mesh dimensions the leaf is cut over (each leaf as
    ``optimizer.global_norm`` counts it)."""
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import cut_axes, param_placements

    specs = flat(param_placements(defs, rules)) if rules is not None else {}
    out = {}
    for k, g in flat(grads).items():
        sq = torch.sum(torch.square(g.detach().float()))
        if rules is not None and cut_axes(specs[k], rules.mesh):
            sq = comm.all_reduce_raw(sq, cut_axes(specs[k], rules.mesh), rules.mesh)
        out[k] = float(torch.sqrt(sq))
    return out


def config(arch: str, size: str):
    from repro_torch.configs import get_config, get_smoke_config

    if size == "smoke":
        return get_smoke_config(arch)
    return dataclasses.replace(get_config(arch), n_layers=FULL_LAYERS)


def batches(arch: str, size: str) -> list:
    """The steps' whole batches (B, S), int64, from ``SyntheticCorpus``."""
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.testing import train_checks as tc

    if size == "smoke":
        return [torch.from_numpy(b).long()
                for b in tc.smoke_batches(STEPS, BATCH, SEQ, arch=arch)]
    cfg = config(arch, size)
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=FULL_SEQ,
                                        global_batch=FULL_BATCH, seed=0))
    return [torch.from_numpy(corpus.batch(s)).long() for s in range(STEPS)]


def opt_config(size: str):
    from repro_torch.testing import train_checks as tc
    from repro_torch.train import OptConfig

    return tc.opt_config(STEPS) if size == "smoke" else OptConfig()


def whole_params(arch: str, size: str, device) -> dict:
    """The JAX initialiser's smoke weights, or at the published width a
    seeded draw on ``device`` (the same on every rank of one card)."""
    from repro_torch.models import lm
    from repro_torch.params import init_params, tree_map
    from repro_torch.testing import train_checks as tc

    if size == "smoke":
        return tree_map(lambda t: t.to(device), tc.smoke_params(arch))
    return init_params(lm.model_defs(config(arch, size)),
                       torch.Generator(device).manual_seed(0), device)


@contextlib.contextmanager
def counting():
    """Counts of the calls of the three Functions whose calls launch the
    kernels on the card, forward and backward (one ``matmul_bwd`` a
    product made), while the block runs."""
    from repro_torch.kernels import flash_attention, matmul, rmsnorm

    counts, saved = {}, []
    for cls, fwd, bwd in ((rmsnorm.RMSNorm, "rmsnorm", "rmsnorm_bwd"),
                          (matmul.Matmul, "matmul", "matmul_bwd"),
                          (flash_attention.FlashAttention, "flash_attention",
                           "flash_attention_bwd")):
        for attr, key in (("forward", fwd), ("backward", bwd)):
            counts[key] = 0
            orig = cls.__dict__[attr]
            saved.append((cls, attr, orig))

            def wrapped(ctx, *a, _orig=orig.__func__, _key=key):
                out = _orig(ctx, *a)
                counts[_key] += (sum(o is not None for o in out)
                                 if _key == "matmul_bwd" else 1)
                return out
            setattr(cls, attr, staticmethod(wrapped))
    try:
        yield counts
    finally:
        for cls, attr, orig in saved:
            setattr(cls, attr, orig)


def _train(cfg, params, rows, bs, opt_cfg, rules, n, bucket_mb, dev, keep=True):
    """Three steps from this rank's blocks ``params``: each step's metrics,
    host ms, collective ms and bytes and (on the card) launches, and with
    ``keep`` the final state on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.params import tree_map
    from repro_torch.testing.subproc import readings
    from repro_torch.train import TrainState, adamw_init, make_train_step
    from repro_torch.train.trainer import make_grad_sync, trainable

    mesh = rules.mesh
    params = trainable(params)
    state = TrainState(params, adamw_init(params, opt_cfg))
    step = make_train_step(cfg, opt_cfg, n, rules=rules,
                           grad_sync=make_grad_sync(cfg, rules, bucket_mb))
    metrics, per_step = [], []
    for b in bs:
        ops.reset_launches()
        with readings(mesh, dev) as st:
            state, m = step(state, {"tokens": rows(b).to(dev)})
            m = {k: float(v) for k, v in m.items()}   # a host read ends the step
        per_step.append({**st, "launches": dict(ops.LAUNCHES)})
        metrics.append(m)
    if not keep:
        return {"metrics": metrics, "steps": per_step}
    return {"metrics": metrics, "steps": per_step,
            "params": tree_map(lambda t: t.detach().cpu(), state.params),
            "opt": tree_map(lambda t: t.cpu(), state.opt)}


def rank_main(args) -> None:
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.params import tree_leaves, tree_map, tree_unflatten
    from repro_torch.parallel.sharding import block, default_rules, shard_tree
    from repro_torch.testing.subproc import join
    from repro_torch.train import global_norm
    from repro_torch.train.trainer import (loss_and_grads, make_grad_sync,
                                           step_launches, trainable)

    with join(args) as world:
        dev = world.device
        mesh = make_debug_mesh(world, *args.mesh)
        res = {"mesh": args.mesh, "archs": {}}
        for arch in args.archs:
            cfg = config(arch, args.size)
            bs = batches(arch, args.size)
            rules = default_rules(mesh, batch=bs[0].shape[0])
            defs = lm.model_defs(cfg)
            spec = rules.spec(("batch", ""))

            def rows(t):
                return block(t, spec, mesh, mesh.rank)

            whole = whole_params(arch, args.size, dev)
            opt_cfg = opt_config(args.size)
            out = {"want_launches": {n: step_launches(cfg, n, rules) for n in MICRO}}
            if args.size == "full":
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                params = trainable(shard_tree(whole, defs, rules, mesh.rank))
                del whole
                out["n_params"] = sum(t.numel() for t in tree_leaves(params))
                loss0, g0 = loss_and_grads(params, rows(bs[0]).to(dev), cfg, None, rules)
                g0 = tree_unflatten(params, make_grad_sync(cfg, rules).reduce(
                    tree_leaves(g0)))
                grads0 = {k: sample(v).cpu() for k, v in flat(g0).items()
                          if k in FULL_LEAVES}
                norms0 = leaf_norms(g0, defs, rules)
                del g0
                run = _train(cfg, params, rows, bs, opt_cfg, rules, 1, None, dev,
                             keep=False)
                out["full"] = {"metrics": run["metrics"], "steps": run["steps"],
                               "loss0": float(loss0), "grads0": grads0,
                               "norms0": norms0,
                               "peak_bytes": (torch.cuda.max_memory_allocated()
                                              if dev.type == "cuda" else None)}
                res["archs"][arch] = out
                continue
            params = trainable(shard_tree(whole, defs, rules, mesh.rank))
            loss0, g0 = loss_and_grads(params, rows(bs[0]).to(dev), cfg, None, rules)
            g0 = tree_unflatten(params, make_grad_sync(cfg, rules).reduce(tree_leaves(g0)))
            out["loss0"] = float(loss0)
            out["grads0"] = tree_map(lambda t: t.cpu(), g0)
            out["gnorm0"] = float(global_norm(g0, rules, defs))
            for n in MICRO:
                for bucket in (None, BUCKET_MB):
                    out[(n, bucket)] = _train(cfg, shard_tree(whole, defs, rules,
                                                              mesh.rank),
                                              rows, bs, opt_cfg, rules, n, bucket, dev)
                a, b = out[(n, None)], out[(n, BUCKET_MB)]
                out[("bucket_same", n)] = all(
                    torch.equal(x, y) for x, y in
                    zip(tree_leaves(a["params"]) + tree_leaves(a["opt"]),
                        tree_leaves(b["params"]) + tree_leaves(b["opt"])))
                with counting() as counts:
                    _train(cfg, shard_tree(whole, defs, rules, mesh.rank), rows,
                           bs[:1], opt_cfg, rules, n, None, dev)
                out[("launches", n)] = dict(counts)
            res["archs"][arch] = out
        torch.save(res, f"{args.dir}/rank{world.rank}.pt")


def assemble(d, world: int, arch: str, n: int, bucket=None) -> dict:
    """One smoke run put together, in ``train_checks.run_smoke``'s form:
    loss0, grads0 (whole), metrics by step, params and optimizer state
    (whole), and the ranks' other readings."""
    from repro_torch.models import lm
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules, gather_tree
    from repro_torch.train.optimizer import opt_state_defs

    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)["archs"][arch]
             for r in range(world)]
    mesh_shape = torch.load(f"{d}/rank0.pt", weights_only=False)["mesh"]
    mesh = Mesh.abstract(mesh_shape, ("data", "model"))
    rules = default_rules(mesh, batch=BATCH)
    cfg = config(arch, "smoke")
    defs = lm.model_defs(cfg)
    odefs = opt_state_defs(defs, opt_config("smoke"))["params"]
    run = [r[(n, bucket)] for r in ranks]
    return {"loss0": ranks[0]["loss0"],
            "grads0": gather_tree([r["grads0"] for r in ranks], defs, rules),
            "metrics": run[0]["metrics"],
            "params": gather_tree([r["params"] for r in run], defs, rules),
            "opt": {"step": run[0]["opt"]["step"],
                    "params": gather_tree([r["opt"]["params"] for r in run],
                                          odefs, rules)},
            "gnorm0": [r["gnorm0"] for r in ranks],
            "bucket_same": [r[("bucket_same", n)] for r in ranks],
            "launches": [r[("launches", n)] for r in ranks],
            "want_launches": ranks[0]["want_launches"][n],
            "same_metrics_on_every_rank": all(r["metrics"] == run[0]["metrics"]
                                              for r in run)}


def main(argv=None) -> dict:
    from repro_torch.testing import train_checks as tc
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("the sharded train step against one process")
    ap.add_argument("nd", type=int, nargs="?", default=2)
    ap.add_argument("nm", type=int, nargs="?", default=2)
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--archs", nargs="*", default=list(SMOKE_ARCHS))
    args = ap.parse_args(argv)
    args.mesh = (args.nd, args.nm)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    world = args.nd * args.nm
    d = run_ranks("repro_torch.testing.check_dist_train", world, str(args.nd),
                  str(args.nm), "--size", args.size, "--archs", *args.archs,
                  device=args.device, workdir=args.dir)
    ok = True
    for arch in args.archs:
        for n in MICRO:
            got = assemble(d, world, arch, n)
            res = tc.compare_runs(got, tc.run_smoke("cpu", STEPS, n, arch), arch)
            same = (all(got["bucket_same"]) and got["same_metrics_on_every_rank"]
                    and all(c == got["want_launches"] for c in got["launches"]))
            ok &= res["ok"] and same
            print(f"check_dist_train {arch} n_microbatches={n} mesh "
                  f"{args.nd}x{args.nm}: {res}; bucketed == unbucketed bitwise "
                  f"{got['bucket_same']}; launches a rank {got['launches'][0]} "
                  f"(step_launches {got['want_launches']})")
    if not ok:
        raise AssertionError("check_dist_train failed")
    print(f"check_dist_train OK (mesh {args.nd}x{args.nm})")
    return {}


if __name__ == "__main__":
    main(sys.argv[1:])
