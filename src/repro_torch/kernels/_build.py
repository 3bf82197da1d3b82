"""Build a CUDA source of ``csrc/`` into a shared library and load it.

``nvcc`` compiles ``csrc/<name>.cu`` (a plain C interface, no PyTorch
headers, so the build takes seconds) into ``build/repro_torch/`` at the
root of the checkout on first use; the library is named by a hash of its
source and of ``csrc/``'s headers (``*.cuh``), so an edited source or
header is rebuilt.  ``build`` compiles several
sources at once, one nvcc process each.  The result is loaded with
``ctypes``.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) per library
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


def _target(name: str) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of every header of ``csrc/`` (a shared header edited rebuilds each
    source that may include it)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Build the libraries of ``names`` that are not built yet, one nvcc
    process for each, all started together."""
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{stderr}")
            continue
        os.replace(tmp, out)            # atomic: a concurrent build never half-loads
        BUILD_LOGS[name] = stderr + stdout
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name in _LIBS:
        return _LIBS[name]
    build([name])
    lib = ctypes.CDLL(str(_target(name)))
    _LIBS[name] = lib
    return lib
