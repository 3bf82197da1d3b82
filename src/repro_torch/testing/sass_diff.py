"""Whether two checkouts compile their CUDA kernels to the same code.

    PYTHONPATH=src python -m repro_torch.testing.sass_diff OTHER_ROOT [LIB ...]

Builds the libraries ``LIB`` (default: both flash-attention sources) in
this checkout and in the one at ``OTHER_ROOT`` (say the parent commit,
unpacked by ``git archive`` under ``build/``), each by its own
``kernels/_build.py``, then disassembles both with ``cuobjdump -sass`` and
compares them kernel instance by kernel instance: one line each,
``identical``, ``DIFFERS`` or found in one tree only.  The anonymous
namespace's name, which carries a hash of the source file, is taken out
of the names and the code before they are compared.  Runs where ``nvcc``
and ``cuobjdump`` are (the machine with the card); exits 1 if a kernel
both trees hold differs.
"""
from __future__ import annotations

import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[3]
ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def _built(root: pathlib.Path, lib: str) -> pathlib.Path:
    """The library ``lib`` of the checkout at ``root``, built by its own
    ``_build`` (the newest of its builds)."""
    code = f"from repro_torch.kernels import _build; _build.build([{lib!r}])"
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   env={**os.environ, "PYTHONPATH": str(root / "src")})
    return max((root / "build" / "repro_torch").glob(f"lib{lib}-*.so"),
               key=lambda p: p.stat().st_mtime)


def sass(path: pathlib.Path) -> dict:
    """Each kernel instance's SASS lines, by name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        line = ANON.sub("ANON", line)
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and line.strip():
            funcs[name].append(line.strip())
    return funcs


def main(argv: list) -> int:
    other = pathlib.Path(argv[0]).resolve()
    differ = 0
    for lib in argv[1:] or ["flash_attention", "flash_attention_bwd"]:
        mine, theirs = sass(_built(ROOT, lib)), sass(_built(other, lib))
        for name in sorted(set(mine) | set(theirs)):
            if name not in mine or name not in theirs:
                what = f"only in {'this tree' if name in mine else other}"
            else:
                what = "identical" if mine[name] == theirs[name] else "DIFFERS"
                differ += what == "DIFFERS"
            print(f"[sass] {lib} {name[:80]}: {what}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
