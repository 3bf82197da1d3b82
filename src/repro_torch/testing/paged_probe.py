"""Where the paged-attention kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.testing.paged_probe

Two inputs, both bf16 at llama3-8b's heads (8 kv heads of 128, 4 query rows
each) over 16-token blocks of a 513-block pool:

* ``decode``: the traced batch-8 decode step of ``chip_smoke.py`` phase 5d
  (``kernel_checks.DECODE_LENS``, 1,836 tokens);
* ``chunk``: one 128-row prefill chunk, one sequence, the last chunk of a
  445-token prompt: rows t = 0..127 with ``lens = 317 + t + 1``, every row
  on the same block table.

For each: the kernel's ms a call between CUDA events (eight copies of the
pools in turn, 269 MB, so each launch finds its K/V cold in L2, as a
decode step's 32 layers do), its device ms a call from a torch.profiler
trace, the bytes bound, and the plan the wrapper takes; then one launch of
a build of ``csrc/paged_attention.cu`` with ``-DPAGED_CYCLES`` (its
``clock64`` stamps, thread 0 of each block): per block, the cycles of each
phase summed over its rounds (prologue, staging wait, scores, softmax,
P.V, epilogue, merge), as medians over the blocks that stamped, the same
per round, and the whole block (median and largest).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import paged_attention as kpa
from repro_torch.testing import kernel_checks as kc

SLOTS = 128                              # stamps a block (csrc STAMP_SLOTS)
PHASES = {0: "prologue", 1: "staging wait", 2: "scores", 3: "softmax", 4: "P.V",
          5: "epilogue", 6: "merge"}
COPIES = 8
NB = 513                                 # the paged serve phase's pool: 512 + the zero block
CHUNK_START, CHUNK_ROWS = 317, 128
HBM_BYTES_S = 3.35e12


def _stamped_library() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "libpaged_attention-cycles.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DPAGED_CYCLES", "-o", str(out),
                    str(_build.CSRC / "paged_attention.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def _inputs(case: str, dev):
    """q, [(kpool, vpool)] * COPIES as (Hkv, NB, bt, D) views, tables, lens."""
    if case == "decode":
        q, k, v, tables, lens = kc.paged_inputs(torch.bfloat16, dev, lens=kc.DECODE_LENS,
                                                nb=NB)
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((CHUNK_ROWS, kc.HKV, kc.HQ // kc.HKV, kc.HEAD_DIM), generator=g,
                        device=dev).to(torch.bfloat16)
        _, k, v, rows, _ = kc.paged_inputs(torch.bfloat16, dev,
                                           lens=(CHUNK_START + CHUNK_ROWS,) * 2, nb=NB)
        tables = rows[:1].expand(CHUNK_ROWS, -1).contiguous()
        lens = torch.arange(CHUNK_START + 1, CHUNK_START + CHUNK_ROWS + 1,
                            dtype=torch.int32, device=dev)
    pools = [(k, v)] + [(k.clone(), v.clone()) for _ in range(COPIES - 1)]
    return q, pools, tables, lens


def _events_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, calls: int) -> float:
    """Mean device ms of the kernels named paged_kernel in a trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and "paged" in e.name]
    if not evs:
        return float("nan")
    return sum(e.time_range.end - e.time_range.start for e in evs) / 1e3 / len(evs)


def phases(stamps: np.ndarray) -> dict:
    """Per block (rows of ``stamps``, SLOTS each): cycles by phase over its
    rounds, its rounds (score phases) and its whole span; blocks with no
    stamp past the start are left out."""
    out = []
    for row in stamps:
        n = int(row[0])
        if n < 2:
            continue
        ph, clk = row[1:1 + 2 * n:2], row[2:2 + 2 * n:2]
        by = {}
        for i in range(1, n):
            by[int(ph[i])] = by.get(int(ph[i]), 0) + int(clk[i] - clk[i - 1])
        out.append({"by": by, "rounds": int((ph == 2).sum()),
                    "whole": int(clk[n - 1] - clk[0])})
    return out


def _report(case: str, blocks: list) -> None:
    if not blocks:
        print(f"[probe] {case}: no block stamped")
        return
    med = lambda xs: int(np.median(xs)) if len(xs) else 0
    line = []
    for p, name in PHASES.items():
        tot = [b["by"].get(p, 0) for b in blocks]
        per = [b["by"].get(p, 0) / b["rounds"] for b in blocks if b["rounds"]]
        if any(tot):
            per_txt = f", {med(per)} a round" if p in (1, 2, 3, 4) else ""
            line.append(f"{name} {med(tot)}{per_txt}")
    rounds = [b["rounds"] for b in blocks]
    wholes = [b["whole"] for b in blocks]
    slow = max(blocks, key=lambda b: b["whole"])
    print(f"[probe] {case}: {len(blocks)} blocks stamped, rounds a block median "
          f"{med(rounds)} (max {max(rounds)}); cycles a block (median): "
          + "; ".join(line) + f"; whole {med(wholes)} (max {max(wholes)}); the "
          f"slowest block: " + ", ".join(f"{PHASES[p]} {c}" for p, c in
                                         sorted(slow["by"].items())))


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"[probe] {torch.cuda.get_device_name(0)}; {smi}")
    lib = _stamped_library()
    lib.repro_paged_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    for case in ("decode", "chunk"):
        q, pools, tables, lens = _inputs(case, dev)
        it = [0]

        def call():
            it[0] += 1
            return kpa.paged_attention(q, *pools[it[0] % COPIES], tables, lens)
        want = kc.ref.paged_attention(q, *pools[0], tables, lens)
        res = kc.compare(kpa.paged_attention(q, *pools[0], tables, lens), want,
                         kc.ATTN_TOL[torch.bfloat16])
        ms, dev_ms = _events_ms(call, 200), _device_ms(call, 64)
        B, Hkv, G, D = q.shape
        # each visible K and V row read once, q read and out written once
        tokens = int(lens.sum()) if case == "decode" else int(lens.max())
        nbytes = tokens * Hkv * D * 2 * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + B * 4
        plan = kpa.plan(B, Hkv, G, tables.shape[1] * pools[0][0].shape[2])
        print(f"[probe] {case}: B={B} Hkv={Hkv} G={G} D={D} lens {lens.min().item()}.."
              f"{lens.max().item()} (sum {int(lens.sum())}); plan {plan}; kernel "
              f"{ms:.4f} ms between events, device {dev_ms:.4f} ms a call; bound "
              f"{1e3 * nbytes / HBM_BYTES_S:.5f} ms (bytes); against plain: "
              f"max_abs_err={res['max_abs_err']:.3e} {'ok' if res['ok'] else 'FAIL'}")
        # one launch of the stamped build through the wrapper
        plain_fn, stamped = kpa._fn(), lib.repro_paged_attention
        stamped.argtypes, stamped.restype = plain_fn.argtypes, plain_fn.restype
        if lib.repro_paged_cycles(None, 0, 1) != 0:
            raise RuntimeError("clearing the cycle stamps failed")
        kpa._FN = stamped
        try:
            got = kpa.paged_attention(q, *pools[0], tables, lens)
            torch.cuda.synchronize()
        finally:
            kpa._FN = plain_fn
        if not kc.compare(got, want, kc.ATTN_TOL[torch.bfloat16])["ok"]:
            raise RuntimeError("the stamped build disagrees with the plain version")
        n_blocks = 8192
        stamps = np.zeros(n_blocks * SLOTS, np.int64)
        if lib.repro_paged_cycles(stamps.ctypes.data, stamps.size, 0) != 0:
            raise RuntimeError("reading the cycle stamps failed")
        _report(case, phases(stamps.reshape(n_blocks, SLOTS)))
        del pools
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
