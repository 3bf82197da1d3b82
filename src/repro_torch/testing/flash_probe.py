"""Where the bf16 flash-attention kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.testing.flash_probe [S ...]

For each prompt length (default 223 445 512; llama3-8b's 32 q heads over 8
kv heads of 128, causal), the consumer warpgroup's phases in cycles, from
one launch of a build of ``csrc/flash_attention.cu`` with
``-DFLASH_CYCLES`` (its ``clock64`` stamps): the prologue (Q and the first K/V tile landing), the
first softmax, and for each key tile the wait before its products, the
products (the next tile's Q K^T with this tile's P V) and the softmax,
rescale and split after them; then the epilogue.  Medians over the 32 heads,
for the q tiles with the longest, a middle and the shortest walk.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.testing import kernel_checks as kc

SLOTS = 32                               # stamps a block (csrc STAMP)


def _stamped_library() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "libflash_attention-cycles.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_CYCLES", "-o", str(out),
                    str(_build.CSRC / "flash_attention.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def main(lengths) -> int:
    if not torch.cuda.is_available():
        print("flash_probe: needs a CUDA card", file=sys.stderr)
        return 2
    lib = _stamped_library()
    lib.repro_flash_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    print(f"[probe] {torch.cuda.get_device_name(0)}")
    for S in lengths:
        q, k, v = kc.flash_inputs(S, torch.bfloat16)
        # one launch of the stamped build through the wrapper
        plain_fn, stamped = kfa._fn(), lib.repro_flash_attention
        stamped.argtypes, stamped.restype = plain_fn.argtypes, plain_fn.restype
        kfa._FN = stamped
        try:
            kfa.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
        finally:
            kfa._FN = plain_fn
        tiles_y = -(-S // kfa.WGMMA_BQ)
        stamps = np.zeros(tiles_y * kc.HQ * SLOTS, np.int64)
        if lib.repro_flash_cycles(stamps.ctypes.data, stamps.size) != 0:
            raise RuntimeError("reading the cycle stamps failed")
        stamps = stamps.reshape(tiles_y, kc.HQ, SLOTS)    # [blockIdx.y][head][slot]
        for y in sorted({0, tiles_y // 2, tiles_y - 1}):
            tiles, t = tiles_y - y, stamps[y]               # q tile tiles_y-1-y walks tiles_y-y
            med = lambda a, b: int(np.median(t[:, b] - t[:, a]))
            steps, prev = [], 2
            for j in range(min(tiles, 9)):
                last = j + 1 == tiles
                steps.append((med(prev, 3 + 3 * j), med(3 + 3 * j, 4 + 3 * j),
                              0 if last else med(4 + 3 * j, 5 + 3 * j)))
                prev = 4 + 3 * j if last else 5 + 3 * j
            print(f"[probe] S={S} q tile {tiles_y - 1 - y} ({tiles} key tiles), cycles: "
                  f"prologue {med(0, 1)}, first softmax {med(1, 2)}, per tile (wait, "
                  f"products, softmax) {steps}, epilogue {med(30, 31)}, whole "
                  f"{med(0, 31)}")
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [223, 445, 512]))
