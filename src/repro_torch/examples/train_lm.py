"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

The port's twin of ``examples/train_lm.py``.  The model is a reduced
llama3-family config (~100M params with tied embeddings), registered in
``configs.archs`` for the launcher as the reference registers it; the run
takes the full training path: the deterministic data pipeline, the
microbatched AdamW step on the card's kernels, async checkpoints every 100
steps with resume from the newest valid one, and the heartbeat and
straggler monitors.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--small]
(--small: the ~0.1M-parameter smoke config; ``--device cpu`` runs the
plain path on the CPU.  Run it again with the same ``--steps`` and
``--ckpt`` to resume where the newest checkpoint left off.)
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib

import torch

from repro_torch.configs import archs, get_config
from repro_torch.configs.archs import smoke_variant
from repro_torch.launch.train import run

#: the checkpoint directory the example defaults to, in the checkout
CKPT = pathlib.Path(__file__).resolve().parents[3] / "build" / "train_lm_ckpt"


def lm100m(small: bool):
    base = get_config("llama3-8b")
    if small:
        return smoke_variant(base)
    return dataclasses.replace(
        base, name="llama3-100m", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=5, d_head=64, d_ff=1792, vocab_size=32000,
        tie_embeddings=True, dtype=torch.float32, remat=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = lm100m(args.small)
    print(f"model: {cfg.name}, {cfg.n_params() / 1e6:.1f}M params")

    archs.CONFIGS[cfg.name] = cfg          # register for the launcher
    out = run(cfg.name, smoke=False, steps=args.steps, global_batch=8,
              seq_len=128, lr=1e-3, ckpt_dir=args.ckpt, ckpt_every=100,
              n_microbatches=2, log_every=10, device=args.device)
    if out["losses"]:
        print(f"loss: {out['losses'][0]:.3f} -> {out['final_loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
