"""Serve a small model with continuously batched requests.

The port's twin of ``examples/serve_batch.py``: the reduced same-family
config of ``--arch`` (mixtral-8x7b by default) through the dense engine at
batch 4 and ``max_seq`` 128, by ``launch.serve.run`` with the reference
example's flags and defaults; ``--device`` (default ``cuda``) picks the
card or the CPU's plain path.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batch [--arch mixtral-8x7b] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import run


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    finished = run(args.arch, smoke=True, n_requests=args.requests,
                   max_new=args.max_new, max_batch=4, max_seq=128,
                   device=args.device)
    for r in finished[:4]:
        print(f"req {r.rid}: prompt[:6]={r.prompt[:6].tolist()} "
              f"-> {len(r.out)} tokens: {r.out[:10]}")
    return finished


if __name__ == "__main__":
    main()
