"""Where fconv2d's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.testing.conv_probe

At table1-card (an 8,198^2 input, a 7x7 filter) in f32 and bf16, and at an
8,200^2 input (rows 16-byte aligned) in both: the kernel's ms a call between
CUDA events, beside two builds of ``csrc/stencil.cu`` that time each half
alone: ``-DCONV_NO_TAPS`` (the input copies and the stores, no taps) and
``-DCONV_NO_LOADS`` (the taps and the stores on stale shared memory, no
copies), and ``F.conv2d`` (cuDNN, no TF32) on the f32 input.  The loaded
library has neither switch.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import stencil as kst
from repro_torch.testing import kernel_checks as kc

SIDES = (8198, 8200)
BUILDS = {"taps only": "-DCONV_NO_LOADS", "loads only": "-DCONV_NO_TAPS"}


def _library(flag: str):
    out = _build.BUILD_DIR / f"libstencil{flag.lower().replace('-dconv', '')}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, flag, "-o", str(out),
                    str(_build.CSRC / "stencil.cu")], check=True, capture_output=True,
                   text=True)
    fn = ctypes.CDLL(str(out)).repro_fconv2d
    fn.argtypes, fn.restype = kst._ARGTYPES["repro_fconv2d"], ctypes.c_int
    return fn


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


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"[conv] {torch.cuda.get_device_name(0)}; {smi}")
    kst._fn("repro_fconv2d")                      # the loaded library, built first
    builds = {"kernel": kst._FNS["repro_fconv2d"],
              **{k: _library(flag) for k, flag in BUILDS.items()}}
    for side in SIDES:
        for dt in (torch.float32, torch.bfloat16):
            x, filt = kc.conv_inputs(side, side, 7, dt)
            r = kc._conv_check(x, filt)
            line = []
            for name, fn in builds.items():
                kst._FNS["repro_fconv2d"] = fn
                try:
                    line.append(f"{name} {_events_ms(lambda: kst.fconv2d(x, filt), 20):.4f}")
                finally:
                    kst._FNS["repro_fconv2d"] = builds["kernel"]
            xf = x.float()
            lib = _events_ms(lambda: torch.nn.functional.conv2d(
                xf[None, None], filt[None, None]), 10)
            print(f"[conv] ({side}, {side}) * 7x7 {str(dt)[6:]:8s} {r['plan']}: ms a call "
                  + ", ".join(line) + f"; F.conv2d (f32) {lib:.4f}; against plain: "
                  f"{'ok' if r['ok'] else 'FAIL'}")
            del x, xf
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
