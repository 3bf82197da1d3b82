"""The environment of a subprocess of the port (the chaos cluster's workers,
the check modules the tests run), and the launcher of the distributed check
modules' ranks (:func:`run_ranks`).

The port's counterpart of ``repro.testing.subproc.pinned_env``: ``src`` on
``PYTHONPATH``, so ``python -m repro_torch...`` imports this checkout's
package whatever the parent inherited.  The port needs no fake-device flag:
its logical devices are ids (``ft.resilience``), and a worker that trains
takes the card it is given by name.
"""
from __future__ import annotations

import contextlib
import os
import pathlib

SRC = str(pathlib.Path(__file__).resolve().parents[2])


def pinned_env() -> dict[str, str]:
    """This process's environment with ``src`` first on ``PYTHONPATH``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    return env


def run_ranks(module: str, world: int, *args: str, device: str = "cuda",
              workdir: str | None = None, timeout: float = 300) -> pathlib.Path:
    """Run ``python -m <module> --rank r --world <world> --dir <d> --device
    <device> <args>`` for every rank r at once, the ranks meeting on a
    ``file://`` store in ``d`` (``workdir``, or a new temporary
    directory), each with one intra-op thread and its output in
    ``d/rank<r>.log``.  Waits for all of them; as soon as one fails (or the
    time runs out) stops the others and raises with every rank's output.
    Prints rank 0's output and returns ``d``, where the ranks leave their
    results."""
    import subprocess
    import sys
    import tempfile
    import time

    from repro_torch.testing.timing import monotonic

    d = pathlib.Path(workdir or tempfile.mkdtemp(prefix="repro_torch_ranks_"))
    d.mkdir(parents=True, exist_ok=True)
    (d / "store").unlink(missing_ok=True)
    env = {**pinned_env(), "OMP_NUM_THREADS": "1"}
    if device == "cuda":                # ranks sharing a card: less fragmentation
        env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    logs = [open(d / f"rank{r}.log", "w") for r in range(world)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, "--rank", str(r), "--world",
             str(world), "--dir", str(d), "--device", device, *args],
            env=env, stdout=f, stderr=subprocess.STDOUT, text=True)
            for r, f in enumerate(logs)]
        t_end = monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or monotonic() > t_end:
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    finally:
        for f in logs:
            f.close()
    text = [(d / f"rank{r}.log").read_text() for r in range(world)]
    if any(p.returncode != 0 for p in procs):
        report = "\n".join(f"--- rank {r} rc={p.returncode} ---\n{t}"
                           for r, (p, t) in enumerate(zip(procs, text)))
        raise AssertionError(f"{module} {args} on {world} ranks failed\n{report}")
    print(text[0], end="")
    return d


def rank_parser(description: str):
    """The argument parser of a rank program: ``--rank``, ``--world``,
    ``--dir`` (the store and the results), ``--device`` (the card unless
    the caller asks for the CPU; :func:`require_device` refuses a card that
    is not there)."""
    import argparse

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def require_device(device: str) -> None:
    """Raise where ``device`` is the card and CUDA is not available."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu")


@contextlib.contextmanager
def join(args):
    """This rank's ``comm.World`` for the block it wraps: one intra-op
    thread, the process group on the run's ``file://`` store; when the
    block ends, a barrier and the group's teardown (a rank that exits with
    its gloo threads alive can abort in C++ at interpreter exit)."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.comm import init_world

    torch.set_num_threads(1)
    store = pathlib.Path(args.dir) / "store"
    world = init_world(args.device, args.rank, args.world, f"file://{store}")
    yield world
    dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def readings(mesh, device):
    """A rank's readings of the block it wraps, filled in when it ends:
    host ms (to a synchronise on the card), ms inside the mesh's
    collectives (host clock, copies through the host included), bytes this
    rank sent, and its peak device bytes (None on the CPU)."""
    import torch

    from repro_torch.testing.timing import now

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = dict(mesh.stats)
    out: dict = {}
    t0 = now()
    yield out
    if cuda:
        torch.cuda.synchronize()
    out.update(ms=1e3 * (now() - t0),
               collective_ms=1e3 * (mesh.stats["seconds"] - before["seconds"]),
               bytes=mesh.stats["bytes"] - before["bytes"],
               peak_bytes=torch.cuda.max_memory_allocated() if cuda else None)
