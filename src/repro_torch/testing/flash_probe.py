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

    PYTHONPATH=src python -m repro_torch.testing.flash_probe --cross

reads the cross-attention rows (3f and 3g, ``CROSS``) instead: the wgmma
forward's and the stats backward's ms a call and their grids' phases in
cycles (a ``-DFLASH_CYCLES`` build of ``csrc/flash_attention_bwd.cu`` too),
and the forward's ms without its K/V loads (``-DFLASH_NO_KV_LOADS``).
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


def _stamped_library(source: str = "flash_attention", defs=()) -> ctypes.CDLL:
    """A ``-DFLASH_CYCLES`` build of ``csrc/<source>.cu``, ``defs`` defined
    too."""
    out = _build.BUILD_DIR / f"lib{source}-cycles{''.join('-' + d.lower() for d in defs)}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DFLASH_CYCLES",
                    *(f"-D{d}" for d in defs), "-o", str(out),
                    str(_build.CSRC / f"{source}.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


#: the cross-attention rows (3f, 3g): vlm's (B, Hq, Hkv, S, Sk, D), non-causal
CROSS = (4, 32, 8, 1024, 6404, 128)


def _events_ms(run, calls: int) -> float:
    for _ in range(2):
        run()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def cross() -> None:
    """At ``CROSS``: the wgmma forward's ms a call between events and its
    consumer's phases in cycles, medians over the blocks of key tiles 1-7
    (the wait before its products, the products, the softmax after them);
    then the stats backward's, the dq grid's per key tile (the wait for the
    next tile, the products, dS and its split) and the dkv grid's per q
    tile (the wait, S^T and dP^T, P^T and dS^T and their splits, dV and
    dK), medians over the blocks of tiles 1-5.  Each stamped build pays
    the same stores."""
    B, Hq, Hkv, S, Sk, D = CROSS
    q, k, v, do = kc.cross_inputs(B, S, Sk, Hq, Hkv, D, torch.bfloat16)
    med = lambda t, x, y: int(np.median(t[:, y] - t[:, x]))
    # the forward without its K/V loads past the ring's first tiles
    # (-DFLASH_NO_KV_LOADS: wrong results, the time the loads cost)
    lib = _stamped_library(defs=("FLASH_NO_KV_LOADS",))
    plain_fn, stamped = kfa._fn(), lib.repro_flash_attention
    stamped.argtypes, stamped.restype = plain_fn.argtypes, plain_fn.restype
    kfa._FN = stamped
    try:
        ms = _events_ms(lambda: kfa.flash_attention(q, k, v, causal=False), 10)
    finally:
        kfa._FN = plain_fn
    print(f"[probe] cross wgmma forward without its K/V loads: {ms:.4f} ms a call")
    lib = _stamped_library()
    lib.repro_flash_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    plain_fn, stamped = kfa._fn(), lib.repro_flash_attention
    stamped.argtypes, stamped.restype = plain_fn.argtypes, plain_fn.restype
    kfa._FN = stamped
    try:
        ms = _events_ms(lambda: kfa.flash_attention(q, k, v, causal=False), 10)
    finally:
        kfa._FN = plain_fn
    blocks = B * Hq * -(-S // kfa.WGMMA_BQ)
    stamps = np.zeros(blocks * SLOTS, np.int64)
    if lib.repro_flash_cycles(stamps.ctypes.data, stamps.size) != 0:
        raise RuntimeError("reading the cycle stamps failed")
    t = stamps.reshape(blocks, SLOTS)
    # tile j at slots 3 + 3j (issued), 4 + 3j (products done), 5 + 3j (softmax)
    phases = [(med(t, 2 + 3 * j, 3 + 3 * j), med(t, 3 + 3 * j, 4 + 3 * j),
               med(t, 4 + 3 * j, 5 + 3 * j)) for j in range(1, 8)]
    print(f"[probe] cross wgmma forward: {ms:.4f} ms a call; per key tile (wait, products, "
          f"softmax) cycles {phases}, whole block {med(t, 0, 31)}")

    _, st = kfa._forward(q, k, v, False, None, stats=True)
    lib = _stamped_library("flash_attention_bwd")
    lib.repro_flash_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    plain_fn, stamped = kfa._bwd_fn(), lib.repro_flash_attention_bwd
    stamped.argtypes, stamped.restype = plain_fn.argtypes, plain_fn.restype
    kfa._BWD = stamped
    try:
        ms = _events_ms(lambda: kfa.backward(q, k, v, do, causal=False, stats=st), 5)
    finally:
        kfa._BWD = plain_fn
    for name, at, blocks, per, labels in (
            ("dq", 0, B * Hq * -(-S // kfa.WGMMA_BQ), 3, "(wait, products, dS)"),
            ("dkv", 1 << 20, B * Hkv * -(-Sk // kfa.WGMMA_BK), 4,
             "(wait, S^T dP^T, P^T dS^T, dV dK)")):
        stamps = np.zeros(blocks * SLOTS, np.int64)
        if lib.repro_flash_cycles(stamps.ctypes.data, stamps.size, at) != 0:
            raise RuntimeError("reading the cycle stamps failed")
        t = stamps.reshape(blocks, SLOTS)
        phases = [tuple(med(t, per * j + i, per * j + i + 1) for i in range(per))
                  for j in range(1, 6)]
        print(f"[probe] cross stats backward ({ms:.4f} ms a call), {name} grid per tile "
              f"{labels} cycles {phases}, whole block {med(t, 0, 31)}")


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
    if sys.argv[1:] == ["--cross"]:
        if not torch.cuda.is_available():
            print("flash_probe: needs a CUDA card", file=sys.stderr)
            sys.exit(2)
        cross()
        sys.exit(0)
    sys.exit(main([int(a) for a in sys.argv[1:]] or [223, 445, 512]))
