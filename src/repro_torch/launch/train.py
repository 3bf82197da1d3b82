"""Training launcher: a few steps of a (smoke or full) model.

The port's counterpart of ``repro.launch.train`` (``run`` and ``main``):
``make_train_step`` over ``make_pipeline``'s synthetic batches, with the
reference's flags and its optimizer settings (``lr``, warmup a tenth of the
steps, cosine to ``--steps``).  Runs on the card unless ``--device cpu``;
weights are random, drawn from ``--seed`` (``run`` also takes a param tree,
so a run can start from weights carried over from JAX).  ``--arch`` takes
every registered arch.  For the cross-attention families (encdec:
seamless-m4t-large-v2; vlm: llama-3.2-vision-11b) each step's batch also
carries a context of ``lm.context_len`` tokens, drawn as the reference's
launcher draws it (:func:`step_context`).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-3.2-vision-11b --device cpu

Checkpoints (``--ckpt``), the chaos harness (``--chaos``, ``--procs`` and
their options) and the heartbeat and straggler monitors come with the
state-and-resilience slice: the flags are refused, not ignored.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.models import lm
from repro_torch.params import tree_map
from repro_torch.serve.engine import resolve_device
from repro_torch.testing.timing import now
from repro_torch.train import OptConfig, TrainState, adamw_init, make_train_step
from repro_torch.train.trainer import init_train_state, trainable

#: the reference's flags that this launcher does not take yet
LATER = ("--ckpt", "--chaos", "--procs", "--chaos-seed", "--chaos-spec",
         "--hosts", "--model-axis", "--ckpt-every", "--timeout",
         "--max-restarts")


def step_context(cfg, step: int, batch: int, seq_len: int) -> np.ndarray:
    """The frontend's embeddings for train step ``step`` of an encdec or vlm
    model, (batch, ``lm.context_len(cfg, seq_len)``, d_ctx) f32: the
    reference launcher's ``default_rng(step).normal(...) * 0.1``."""
    rng = np.random.default_rng(step)
    T = lm.context_len(cfg, seq_len)
    return (rng.normal(size=(batch, T, cfg.d_ctx)) * 0.1).astype(np.float32)


def run(arch: str, *, smoke: bool = True, steps: int = 50,
        global_batch: int = 8, seq_len: int = 64, lr: float = 3e-3,
        n_microbatches: int = 1, log_every: int = 10, seed: int = 0,
        device="cuda", params: dict | None = None) -> dict:
    """``steps`` train steps from step 0; returns the losses.  ``params``
    (a tree on any device) replaces the seeded random init."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(2, steps // 10),
                        total_steps=steps)
    if params is None:
        state = init_train_state(cfg, opt_cfg,
                                 torch.Generator(device=device).manual_seed(seed),
                                 device)
    else:
        p = trainable(tree_map(lambda t: t.to(device), params))
        state = TrainState(p, adamw_init(p, opt_cfg))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch, seed=seed)
    pipe = make_pipeline(dcfg)
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=n_microbatches)
    losses = []
    t_prev = now()
    try:
        for step in range(steps):
            batch = {"tokens": torch.from_numpy(next(pipe)).to(device, torch.int64)}
            if cfg.family in lm.CONTEXT_FAMILIES:
                batch["ctx"] = torch.from_numpy(
                    step_context(cfg, step, global_batch, seq_len)).to(device)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])     # a host read: the step is done
            losses.append(loss)
            dt = now() - t_prev
            t_prev = now()
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt * 1e3:.0f} ms) [{device}]", flush=True)
    finally:
        pipe.close()
    return {"losses": losses, "final_loss": losses[-1] if losses else None}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    help="a registered arch: dense, MoE (mixtral-8x7b, "
                         "qwen3-moe-235b-a22b), mamba2-370m, "
                         "jamba-1.5-large-398b, seamless-m4t-large-v2 (encdec) "
                         "or llama-3.2-vision-11b (vlm)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="full published config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    known = [a for a in argv if a.split("=")[0] in LATER]
    if known:
        ap.error(f"{', '.join(known)}: checkpoints, the chaos harness and the "
                 f"host monitors are not ported yet (they come with the "
                 f"state-and-resilience slice)")
    args = ap.parse_args(argv)
    out = run(args.arch, smoke=not args.full, steps=args.steps,
              global_batch=args.batch, seq_len=args.seq, lr=args.lr,
              n_microbatches=args.microbatches, seed=args.seed,
              device=args.device)
    print(f"[train] done: first loss {out['losses'][0]:.4f} "
          f"final {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
