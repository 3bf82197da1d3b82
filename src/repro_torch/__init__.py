"""PyTorch/CUDA port of the ``repro`` package, for NVIDIA Hopper (sm_90a).

Module names mirror ``repro`` so each counterpart is easy to find.  The
package imports torch and numpy only: never jax, never ``repro``, and never
triton or the CUDA toolchain at import time (kernels are built on first
launch).  Entry points run on the card unless the caller asks for the CPU;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
