"""Distributed check: a checkpoint saved from a process mesh restores onto
another mesh and in one process, bit for bit.

    PYTHONPATH=src python -m repro_torch.testing.check_ckpt_mesh --device cpu

runs 4 ranks (gloo on the CPU).  On a (2, 2) ``(data, model)`` mesh they
take one train step of llama3-8b's smoke model from the JAX initialiser's
weights (so that the optimizer's moments are not zeros), gather the state
to rank 0 (``checkpoint.ckpt.gather_to_writer``), which writes it
(``save_checkpoint``, the JAX package's format); then ranks 0 and 1 build a
(1, 2) mesh of their own (``comm.Mesh.over_ranks``), restore the
checkpoint onto it (``restore_checkpoint(..., rules=)``) and gather it
back.  The launcher holds every leaf's crc32 of the (1, 2) gather and of a
restore in one process to the written files, and each (1, 2) rank's
blocks to ``sharding.block`` of the one-process restore.
``tests/test_torch_checkpoint.py`` runs it on the CPU; ``chip_smoke.py``
(phase 13 e) on the card.
"""
from __future__ import annotations

import sys
import zlib

import torch

RANKS, ARCH = 4, "llama3-8b"


def crcs(tree) -> list:
    """The crc32 of each leaf's stored bytes, in the checkpoint's order."""
    from repro_torch.checkpoint.ckpt import _to_numpy, flatten

    return [zlib.crc32(_to_numpy(t)[0].tobytes()) for t in flatten(tree)]


def _state_defs(cfg, opt_cfg):
    from repro_torch.train import TrainState
    from repro_torch.train.trainer import train_state_defs

    return TrainState(*train_state_defs(cfg, opt_cfg))


def rank_main(args) -> None:
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.checkpoint.ckpt import gather_to_writer
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.params import tree_map
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import block, default_rules, shard_tree
    from repro_torch.testing import train_checks as tc
    from repro_torch.testing.subproc import join
    from repro_torch.train import (TrainState, abstract_train_state, adamw_init,
                                   make_train_step)
    from repro_torch.train.trainer import trainable

    with join(args) as world:
        dev = world.device
        cfg, opt_cfg = get_smoke_config(ARCH), tc.opt_config(3)
        defs = _state_defs(cfg, opt_cfg)
        mesh = make_debug_mesh(world, 2, 2)
        rules = default_rules(mesh, batch=4)
        whole = tree_map(lambda t: t.to(dev), tc.smoke_params(ARCH))
        p = trainable(shard_tree(whole, lm.model_defs(cfg), rules, mesh.rank))
        state = TrainState(p, adamw_init(p, opt_cfg))
        toks = torch.from_numpy(tc.smoke_batches(1)[0]).long()
        rows = block(toks, rules.spec(("batch", "")), mesh, mesh.rank)
        state, _ = make_train_step(cfg, opt_cfg, rules=rules)(state, {"tokens": rows.to(dev)})
        saved = gather_to_writer(state, defs, rules)
        if saved is not None:
            save_checkpoint(f"{args.dir}/ckpt", saved, step=1)
            torch.save({"saved": crcs(saved)}, f"{args.dir}/saved.pt")
        dist.barrier()
        if world.rank < 2:
            sub = Mesh.over_ranks([0, 1], (1, 2), ("data", "model"), world.transport)
            r12 = default_rules(sub, batch=4)
            st, step, _ = restore_checkpoint(f"{args.dir}/ckpt",
                                             abstract_train_state(cfg, opt_cfg),
                                             device=dev, rules=r12)
            back = gather_to_writer(st, defs, r12)
            torch.save({"step": step,
                        "blocks": TrainState(*(tree_map(lambda t: t.cpu(), x) for x in st)),
                        "back": None if back is None else crcs(back)},
                       f"{args.dir}/rank{world.rank}.pt")


def check(d) -> dict:
    """The (1, 2) gather's and a one-process restore's crc32s against the
    written files'; each (1, 2) rank's blocks against ``block`` of the
    one-process restore."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import block, default_rules
    from repro_torch.testing import train_checks as tc
    from repro_torch.train import abstract_train_state

    cfg, opt_cfg = get_smoke_config(ARCH), tc.opt_config(3)
    saved = torch.load(f"{d}/saved.pt")["saved"]
    template = abstract_train_state(cfg, opt_cfg)
    one, _, _ = restore_checkpoint(f"{d}/ckpt", template, device="cpu")
    ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(2)]
    mesh = Mesh.abstract((1, 2), ("data", "model"))
    rules = default_rules(mesh, batch=4)
    blocks_ok = all(
        torch.equal(got, block(w, rules.spec(pv.logical), mesh, r))
        for r, rk in enumerate(ranks)
        for got, w, pv in zip(flatten(rk["blocks"]), flatten(one), flatten(template)))
    out = {"n_leaves": len(saved), "one_process": crcs(one) == saved,
           "mesh_1x2": ranks[0]["back"] == saved, "blocks": blocks_ok,
           "step": ranks[0]["step"]}
    if not (out["one_process"] and out["mesh_1x2"] and out["blocks"] and out["step"] == 1):
        raise AssertionError(f"check_ckpt_mesh failed: {out}")
    return out


def main(argv=None) -> dict:
    from repro_torch.testing.subproc import rank_parser, require_device, run_ranks

    ap = rank_parser("a (2, 2) save restored onto (1, 2) and in one process")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return {}
    require_device(args.device)
    d = run_ranks("repro_torch.testing.check_ckpt_mesh", RANKS, device=args.device,
                  workdir=args.dir, timeout=600)
    out = check(d)
    print(f"check_ckpt_mesh OK on {args.device}: a (2, 2) save of {out['n_leaves']} "
          f"leaves restored onto (1, 2) and in one process, every leaf's crc32 equal")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
