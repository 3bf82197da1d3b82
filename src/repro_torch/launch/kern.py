"""Kernel micro-benchmark: the port's twin of the JAX benchmark's ``kern``
section (``benchmarks/run.py::bench_kernels``).

Three CSV rows, each a kernel's time beside its plain version's, in
microseconds: ``kern/matmul_256`` ((256, 256) @ (256, 256) f32),
``kern/softmax_rows`` ((32, 512) f32) and ``kern/flash_attn`` (causal GQA,
q (1, 4, 256, 64), k/v (1, 2, 256, 64) f32).  Inputs are drawn with numpy
from seed 0.  Runs on the card unless ``--device cpu``, where the seam
takes the plain versions, so both columns time plain torch.  On the card
the times come from CUDA events around ``REPS`` calls; on the CPU from the
host clock.

    PYTHONPATH=src python -m repro_torch.launch.kern
    PYTHONPATH=src python -m repro_torch.launch.kern --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.serve.engine import resolve_device
from repro_torch.testing.timing import now

REPS = 20


def time_us(fn, device: torch.device) -> float:
    """Mean microseconds of ``fn()`` over ``REPS`` calls after one warm-up."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return 1e3 * start.elapsed_time(end) / REPS
    t0 = now()
    for _ in range(REPS):
        fn()
    return 1e6 * (now() - t0) / REPS


def run(device="cuda") -> list[str]:
    """Time the three kernels and their plain versions; returns the rows."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    a, b = draw(256, 256), draw(256, 256)
    x = draw(32, 512)
    q, k, v = draw(1, 4, 256, 64), draw(1, 2, 256, 64), draw(1, 2, 256, 64)
    cases = [
        ("kern/matmul_256", lambda: ops.matmul(a, b), lambda: ref.matmul(a, b)),
        ("kern/softmax_rows", lambda: ops.softmax_rows(x),
         lambda: ref.softmax_rows(x)),
        ("kern/flash_attn", lambda: ops.attention(q, k, v, causal=True),
         lambda: ref.attention(q, k, v, causal=True)),
    ]
    rows = []
    for name, kernel, plain in cases:
        us_k, us_p = time_us(kernel, device), time_us(plain, device)
        rows.append(f"{name},{us_k:.1f},plain={us_p:.1f}us")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions)")
    print(f"# kern on {name}: name,kernel_us,plain_us")
    for row in run(device):
        print(row)


if __name__ == "__main__":
    main()
