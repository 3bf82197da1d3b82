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

    PYTHONPATH=src python -m repro_torch.testing.flash_probe --f32

reads the f32 kernels (``tf32x3``) at rows 3b and 3h (``F32_ROWS``): the
forward as committed (TF32 wgmma) beside the same forward on the
backward's ``mma.sync`` helpers (``csrc/flash_fwd_mma_probe.cu``, a probe
built here, with K and V split as a warp reads them and split once at
load), each one's limit use against the plain version and its us a call
(``timing.measure_us``, behind a spin kernel) in turns, then the reverse
order, and the probe's registers and spills; the backward's limit use and
ms a call; then the opcodes of the f32 kernels' SASS (``cuobjdump
-sass``), most frequent first.
"""
from __future__ import annotations

import ctypes
import pathlib
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
#: the f32 rows: 3b's forward (B, S) and 3h's backward, the llama3-8b heads,
#: causal
F32_ROWS = {"3b": (1, 512), "3h": (4, 1024)}
#: the f32 forward on the backward's mma.sync helpers, built by ``--f32``
MMA_PROBE = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_fwd_mma_probe.cu"


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


def _mma_probe_library() -> tuple[ctypes.CDLL, str]:
    """``MMA_PROBE`` built, and ptxas's lines for it."""
    out = _build.BUILD_DIR / "libflash_fwd_mma_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(MMA_PROBE)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.repro_flash_fwd_mma_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, r.stdout + r.stderr


def _mma_forward(lib, q, k, v, split: int) -> torch.Tensor:
    """Causal attention through the probe's forward (``split`` as its csrc
    header says)."""
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, S, D), device=q.device, dtype=torch.float32)
    st = (ctypes.c_longlong * 12)(*(x for t in (q, k, v, out) for x in t.stride()[:3]))
    rc = lib.repro_flash_fwd_mma_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       out.data_ptr(), B, Hq, Hkv, S, Sk, D, 1, 0, st, split,
                                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the mma.sync forward probe failed to launch: CUDA error {rc}")
    return out


def f32() -> None:
    """``--f32`` (module docstring)."""
    import re
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import ref
    from repro_torch.testing.timing import measure_us

    with ThreadPoolExecutor(1) as pool:           # the probe's nvcc beside the package's
        job = pool.submit(_mma_probe_library)
        kfa._fn(), kfa._bwd_fn()
    lib, log = job.result()
    fn = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = "flash_fwd_mma" in line and re.search(r"ILi(\d+)ELb(\d)E", line)
        elif fn and ("registers" in line or "spill" in line):
            print(f"[probe] ptxas mma.sync forward D={fn.group(1)} split={fn.group(2)}: "
                  f"{line.split(':', 1)[-1].strip()}")
    B, S = F32_ROWS["3b"]
    q, k, v = kc.flash_inputs(S, torch.float32, B=B)
    want = ref.attention(q, k, v, causal=True)
    runs = {"tf32x3 (TF32 wgmma)": lambda *a: kfa.flash_attention(*a, causal=True),
            "mma.sync, K/V split as read": lambda *a: _mma_forward(lib, *a, 0),
            "mma.sync, K/V split at load": lambda *a: _mma_forward(lib, *a, 1)}
    for name, run in runs.items():
        out = run(q, k, v)
        use = kc.compare(out, want, kc.ATTN_TOL[torch.float32])["limit_use"]
        print(f"[probe] f32 forward 3b {name}: limit use {use:.3f}, same bits twice "
              f"{bool(torch.equal(out, run(q, k, v)))}")
    us = {name: [] for name in runs}
    for name in list(runs) + list(reversed(runs)):
        # between events behind a spin kernel (q, k, v on the card)
        us[name].append(measure_us(runs[name], q, k, v, reps=10, inner=20).median_us)
    for name, ts in us.items():
        print(f"[probe] f32 forward 3b {name}: us a call in turns "
              + " / ".join(f"{t:.2f}" for t in ts))
    B2, S2 = F32_ROWS["3h"]
    q2, k2, v2, do = kc.attention_bwd_inputs(B2, S2, torch.float32)
    want2 = ref.attention_bwd(q2, k2, v2, do, causal=True)
    use2 = max(kc.compare(g, w, kc.ATTN_BWD_TOL[torch.float32])["limit_use"] for g, w
               in zip(kfa.backward(q2, k2, v2, do, causal=True), want2))
    ms2 = _events_ms(lambda: kfa.backward(q2, k2, v2, do, causal=True), 10)
    print(f"[probe] f32 backward 3h tf32x3: limit use {use2:.3f}, {ms2:.4f} ms a call")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib in ("flash_attention", "flash_attention_bwd"):
        out = subprocess.run([tool, "-sass", str(_build._target(lib))], capture_output=True,
                             text=True, check=True).stdout
        for func in re.split(r"\n\s*Function : ", out)[1:]:
            name = func.split("\n", 1)[0]
            if "tf32" not in name or "128" not in name:
                continue
            ops = {}
            for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", func):
                ops[op] = ops.get(op, 0) + 1
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:14]
            short = re.sub(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", name)[:60]
            print(f"[probe] sass {short}: {sum(ops.values())} instructions, "
                  + ", ".join(f"{o} {n}" for o, n in top))


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
    if sys.argv[1:] in (["--cross"], ["--f32"]):
        if not torch.cuda.is_available():
            print("flash_probe: needs a CUDA card", file=sys.stderr)
            sys.exit(2)
        (cross if sys.argv[1] == "--cross" else f32)()
        sys.exit(0)
    sys.exit(main([int(a) for a in sys.argv[1:]] or [223, 445, 512]))
