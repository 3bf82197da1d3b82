"""Probe: does NCCL take two ranks of one communicator on one card?

    PYTHONPATH=src python -m repro_torch.testing.nccl_probe

starts two ranks on one card (both on ``cuda:0``), each joining an NCCL
process group on a ``file://`` store and summing one tensor, and prints
what each rank saw: the sum, or the error NCCL raised.  It records a fact
about the layout; nothing reads its result to pick a backend
(``parallel.comm.layout`` is a plain function of the layout).  Exits 0
whichever way NCCL answers; non-zero only if the probe itself could not
run (no card).
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

#: seconds the ranks may take before the probe stops them and says so
TIMEOUT_S = 120


def _rank(rank: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}", rank=rank,
                                world_size=2)
        x = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        print(f"rank {rank}: all_reduce gave {x.tolist()}", flush=True)
    except Exception as e:              # the outcome this probe reports
        print(f"rank {rank}: {type(e).__name__}: {str(e).splitlines()[0][:300]}",
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nccl_probe: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.testing.subproc import pinned_env

    store = os.path.join(tempfile.mkdtemp(prefix="nccl_probe_"), "store")
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.testing.nccl_probe",
                               "--rank", str(r), store], env=pinned_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += f"\n(stopped after {TIMEOUT_S} s: no answer)"
        print("\n".join(l for l in out.splitlines()
                        if l.startswith("rank") or "stopped" in l or "NCCL" in l))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        _rank(int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
