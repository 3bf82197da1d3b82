"""The port's whole check on a machine with one H100, from the root of a
checkout:

    PYTHONPATH=src python -m repro_torch.testing.chip_proof [--out build/chip_proof]

Runs, one after another, and prints each one's exit code:
  1. ``python3 chip_smoke.py`` (its output to ``OUT/smoke.txt`` and
     ``OUT/smoke.err``; the lines of its Table I phases, its kernel times,
     its training phases, its MoE, Mamba2 and cross-attention phases,
     their splits by sublayer, its state-and-resilience phase, its
     distributed and mesh phases, its tooling phase's summary lines and
     its last two lines echoed);
  2. ``python -m repro_torch.launch.kern`` (the ``kern`` rows);
  3. the gpu-marked tests, ``pytest -m gpu tests/test_torch_gpu.py
     tests/test_torch_tooling_gpu.py``;
  4. ``chip_smoke.py`` copied alone into an empty directory, where it must
     fail: it finds no ``src/repro_torch`` beside it.  Its last line of
     errors is echoed.
Exits 0 only when 1-3 exit 0 and 4 does not.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile


def _run(cmd: list, cwd: pathlib.Path, timeout: int, **kw) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(cwd / "src")}
    return subprocess.run(cmd, cwd=cwd, env=env, timeout=timeout, text=True, **kw)


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/chip_proof",
                    help="where chip_smoke.py's output goes (default build/chip_proof)")
    args = ap.parse_args(argv)
    root = pathlib.Path.cwd()
    out = root / args.out
    out.mkdir(parents=True, exist_ok=True)

    with open(out / "smoke.txt", "w") as so, open(out / "smoke.err", "w") as se:
        smoke = _run([sys.executable, "chip_smoke.py"], root, 1200, stdout=so, stderr=se)
    print(f"smoke rc={smoke.returncode}")
    lines = (out / "smoke.txt").read_text().splitlines()
    for ln in lines[:-2]:
        if ln.startswith(("[table1]", "[sweep]", "[time]", "[build]", "[train", "[moe",
                          "[ssm]", "[xattn", "[split]", "[state]", "check_chaos",
                          "[dist]", "[mesh]", "[tooling]", "[dryrun]", "[done]",
                          "[tune] wgmma")) or "signatures in" in ln:
            print(ln[:400])
    print("\n".join(ln[:400] for ln in lines[-2:]))
    print("\n".join((out / "smoke.err").read_text().splitlines()[-5:]))

    kern = _run([sys.executable, "-m", "repro_torch.launch.kern"], root, 600)
    print(f"kern rc={kern.returncode}")

    tests = _run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                  "-m", "gpu", "tests/test_torch_gpu.py",
                  "tests/test_torch_tooling_gpu.py"], root, 900,
                 capture_output=True)
    print("\n".join(tests.stdout.splitlines()[-(3 if tests.returncode == 0 else 40):]))
    print(f"gpu tests rc={tests.returncode}")

    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as alone:
        shutil.copy(root / "chip_smoke.py", alone)
        solo = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone, timeout=300,
                              capture_output=True, text=True,
                              env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    err = solo.stderr.strip().splitlines()
    print(f"alone rc={solo.returncode} (must not be 0): {err[-1] if err else ''}")
    print(f"alone stdout lines: {len(solo.stdout.splitlines())}")

    ok = (smoke.returncode == kern.returncode == tests.returncode == 0
          and solo.returncode != 0)
    print(f"proof {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
