"""Crash-atomic, async checkpoints of a train state (no external deps).

The port's counterpart of ``repro.checkpoint.ckpt``, writing the same
format leaf for leaf, so a checkpoint written by either package restores
in the other:

    <path>/step_%08d/manifest.json   step, n_leaves, extra, and each leaf's
                                     shape, logical dtype and file bytes
    <path>/step_%08d/leaf_%05d.npy   one ``np.save`` file a leaf

Leaves are numbered in the JAX package's flatten order: dict keys sorted,
tuples (``TrainState``: params, then opt) in order.  The port's own tree
walk (``params.tree_leaves``) keeps insertion order, so this module
flattens on its own (:func:`flatten`).  bf16 is stored as its ``uint16``
bits under ``"dtype": "bfloat16"``; the opt ``step`` is a 0-d int32 array.

Fault tolerance, as the reference's:

* atomic publish: every file is written as ``<name>.part``, fsynced and
  ``os.replace``d, and the step is staged as ``<dir>.tmp`` and published by
  one ``os.replace``, so a crashed writer never leaves a step that looks
  whole;
* the torn-write gate: a step counts only if its manifest parses and every
  leaf file has its recorded byte size (:func:`valid_steps`); restore and
  retention skip the rest;
* async: ``CheckpointManager.save_async`` copies the state to host memory
  on the caller's thread (a copy, finished before it returns: the train
  step updates the state's tensors in place) and serialises on a worker
  thread;
* retention: the newest ``keep`` valid steps stay.

Restore places every leaf on one ``device``, each allocated there once,
from a template of shapes and dtypes (``train.trainer.abstract_train_state``)
or of tensors.  On a process mesh a checkpoint holds the whole leaves, as
the reference's does: :func:`gather_to_writer` brings every rank's blocks
to the mesh's first rank, which writes them, and ``restore_checkpoint(...,
rules=, rank=)`` cuts each leaf's block for the target rules, which may be
those of another mesh (the survivors of an elastic rescale) or of one
process: the placement is a pure function of the leaf's logical axes and
the mesh.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.parallel.sharding import ShardingRules, block, gather_tree
from repro_torch.testing.timing import now


class SimulatedCrash(RuntimeError):
    """Raised by ``save_checkpoint(crash_after_leaves=...)``: the chaos
    harness's stand-in for a writer dying mid-save.  The write goes to
    ``<dir>.tmp`` and publishes by ``os.replace``, so a crash before the
    publish leaves only a ``.tmp`` directory that every reader ignores."""


def flatten(tree) -> list:
    """The leaves of ``tree`` in the JAX package's flatten order: dict keys
    sorted, tuples and lists (a ``TrainState``) in order, ``None`` none."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [] if tree is None else [tree]


def unflatten(tree, leaves) -> Any:
    """A tree shaped like ``tree`` (its dicts in their own key order) whose
    leaves are ``leaves``, taken in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(an npy-portable array, the logical dtype's name) of a leaf, on the
    host (a CPU tensor's memory is shared, not copied)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor a stored leaf holds, on the CPU (bit-exact)."""
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _fsync_dir(d: pathlib.Path) -> None:
    """Make a directory entry durable (the rename lives in the directory,
    not the file: without this a crash can keep the file and lose the
    name)."""
    fd = os.open(d, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish_bytes(dest: pathlib.Path, data: bytes | np.ndarray) -> int:
    """Crash-atomic single-file write of ``data`` (bytes, or an array in
    ``np.save``'s format): a same-directory ``.part`` name, flush and fsync
    the data, then ``os.replace`` the name.  A SIGKILL at any instant
    leaves either no ``dest`` or a whole one, never the right name over
    torn bytes.  Returns the bytes written."""
    tmp = dest.with_name(dest.name + ".part")
    with open(tmp, "wb") as f:
        if isinstance(data, np.ndarray):
            np.save(f, data)
        else:
            f.write(data)
        f.flush()
        os.fsync(f.fileno())
        nbytes = f.tell()
    os.replace(tmp, dest)
    return nbytes


def save_checkpoint(path: str | pathlib.Path, tree: Any, step: int,
                    extra: dict | None = None,
                    crash_after_leaves: int | None = None,
                    after_leaf: Callable[[int], None] | None = None,
                    ) -> pathlib.Path:
    """Write one step directory with two layers of crash-atomicity: every
    file goes through :func:`_publish_bytes`, and the directory is staged
    as ``<dir>.tmp`` and published by a last ``os.replace``.
    ``crash_after_leaves=n`` raises :class:`SimulatedCrash` before leaf
    ``n``; ``after_leaf(i)`` runs once leaf ``i`` is durable (the
    multi-process chaos harness parks the writer there, so a real SIGKILL
    lands between leaf writes with the manifest unpublished)."""
    path = pathlib.Path(path)
    final = path / f"step_{step:08d}"
    tmp = path / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves), "extra": extra or {},
                "leaves": []}
    for i, leaf in enumerate(leaves):
        if crash_after_leaves is not None and i >= crash_after_leaves:
            raise SimulatedCrash(
                f"simulated writer crash after {i} of {len(leaves)} leaves "
                f"(step {step}; only {tmp.name} exists, never {final.name})")
        arr, logical_dtype = _to_numpy(leaf)
        nbytes = _publish_bytes(tmp / f"leaf_{i:05d}.npy", arr)
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": logical_dtype, "nbytes": nbytes})
        if after_leaf is not None:
            after_leaf(i)
    _publish_bytes(tmp / "manifest.json", json.dumps(manifest).encode())
    _fsync_dir(tmp)                           # leaf names durable pre-publish
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                    # atomic publish
    _fsync_dir(path)
    return final


def _step_dir_valid(d: pathlib.Path) -> bool:
    """The crash-consistency gate of one published ``step_*`` directory:
    the manifest parses and every leaf file exists with its recorded byte
    size.  A torn step is skipped, never a crash at restore time; a
    manifest without ``nbytes`` falls back to an existence check."""
    try:
        manifest = json.loads((d / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError):
        return False
    for i, meta in enumerate(manifest.get("leaves", [])):
        f = d / f"leaf_{i:05d}.npy"
        if not f.exists():
            return False
        want = meta.get("nbytes")
        if want is not None and f.stat().st_size != want:
            return False
    return len(manifest.get("leaves", [])) == manifest.get("n_leaves", -1)


def valid_steps(path: str | pathlib.Path) -> list:
    """Sorted steps whose directory passes the torn-write gate."""
    path = pathlib.Path(path)
    if not path.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in path.glob("step_*")
                  if not p.name.endswith(".tmp") and _step_dir_valid(p))


def latest_step(path: str | pathlib.Path) -> int | None:
    """The newest *valid* step: a torn newest checkpoint is skipped for the
    durable one before it."""
    steps = valid_steps(path)
    return steps[-1] if steps else None


def tear_checkpoint(path: str | pathlib.Path, step: int,
                    leaf: int = 0) -> pathlib.Path:
    """Corrupt a *published* checkpoint on purpose, truncating one leaf file
    to half its size: the chaos injector's ``ckpt_crash`` (a torn write
    that survived ``os.replace``).  ``valid_steps`` then skips the step."""
    d = pathlib.Path(path) / f"step_{step:08d}"
    f = d / f"leaf_{leaf:05d}.npy"
    data = f.read_bytes()
    f.write_bytes(data[: max(1, len(data) // 2)])
    return d


def gather_to_writer(tree: Any, defs: Any, rules: ShardingRules) -> Any:
    """The whole tree of a state held in blocks over ``rules``' mesh
    (``defs`` its ``PV`` tree), on the mesh's first rank, None on the
    others: every rank's blocks go to it on the host in one gather over
    the mesh, and ``sharding.gather_tree`` puts them together.  Every rank
    of the mesh calls it."""
    from repro_torch.parallel import comm

    mesh = rules.mesh
    host = _map_tree(lambda t: t.detach().to("cpu", copy=True), tree)
    if mesh.size == 1:
        return host
    got = comm.gather_objects(host, mesh)
    if got is None:
        return None
    if isinstance(defs, tuple) and hasattr(defs, "_fields"):   # a TrainState
        return type(defs)(*[gather_tree([g[i] for g in got], d, rules)
                            for i, d in enumerate(defs)])
    return gather_tree(got, defs, rules)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tree(fn, v) for v in tree])
    return fn(tree)


def restore_checkpoint(path: str | pathlib.Path, template: Any,
                       step: int | None = None, device="cuda",
                       rules: ShardingRules | None = None,
                       rank: int | None = None):
    """Restore into the structure of ``template`` (leaves: tensors, or
    ``PV``s from ``abstract_train_state``), each leaf read from its file,
    cast to the template's dtype where it differs, and allocated once on
    ``device``.  ``step=None`` takes the newest step that passes the
    torn-write gate.  Returns ``(tree, step, extra)``.

    With ``rules`` on a mesh (the template's leaves then ``PV``s, whose
    logical axes place them) each leaf becomes the block of mesh position
    ``rank`` (the mesh's own rank by default), ``sharding.block`` of the
    whole stored leaf: any mesh, whatever mesh wrote it."""
    mesh = None if rules is None else rules.mesh
    if mesh is not None and rank is None:
        rank = mesh.rank
    path = pathlib.Path(path)
    step = latest_step(path) if step is None else step
    assert step is not None, f"no valid checkpoint under {path}"
    d = path / f"step_{step:08d}"
    if not _step_dir_valid(d):
        raise ValueError(
            f"checkpoint step {step} under {path} is torn or missing; "
            f"valid steps: {valid_steps(path)}")
    manifest = json.loads((d / "manifest.json").read_text())
    likes = flatten(template)
    if manifest["n_leaves"] != len(likes):
        raise ValueError(f"tree structure changed: the checkpoint has "
                         f"{manifest['n_leaves']} leaves, the template "
                         f"{len(likes)}")
    out = []
    for i, like in enumerate(likes):
        t = _from_numpy(np.load(d / f"leaf_{i:05d}.npy"),
                        manifest["leaves"][i]["dtype"])
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: stored shape {tuple(t.shape)}, the "
                             f"template's {tuple(like.shape)}")
        if mesh is not None:
            t = block(t, rules.spec(like.logical), mesh, rank)
        # a tensor of torch's allocator on ``device`` (numpy's buffers have
        # another alignment, and the CPU's matmuls round by alignment), in
        # the template's dtype (a tensor's or a ``PV``'s)
        out.append(torch.empty(t.shape, dtype=like.dtype, device=device).copy_(t))
    return unflatten(template, out), step, manifest["extra"]


class CheckpointManager:
    """Async writer with retention: snapshot on the caller's thread (a
    device-to-host copy), serialise on a worker thread, one save in
    flight.  ``timings`` gets one record a save: its step, the seconds the
    snapshot held the caller (``snapshot_s``), the writer's seconds
    (``write_s``, retention included) and the bytes written."""

    def __init__(self, path: str | pathlib.Path, keep: int = 3):
        self.path = pathlib.Path(path)
        self.keep = keep
        self.timings: list[dict] = []
        self._worker: threading.Thread | None = None
        self._err: Exception | None = None

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._err:
            raise self._err

    def in_flight(self) -> bool:
        """Whether a save is still being written."""
        return self._worker is not None and self._worker.is_alive()

    def save_async(self, tree: Any, step: int, extra: dict | None = None):
        self.wait()                                  # one in flight
        t0 = now()
        # a host copy that owns its memory, in flatten's order: the caller
        # updates the state in place as soon as this returns (``.cpu()`` of
        # a CPU tensor, or ``.numpy()``, would share it)
        host = [leaf.detach().to("cpu", copy=True) for leaf in flatten(tree)]
        snapshot_s = now() - t0

        def run():
            try:
                t1 = now()
                d = save_checkpoint(self.path, host, step, extra)
                nbytes = sum(f.stat().st_size for f in d.iterdir())
                self._gc()
                self.timings.append({"step": step, "snapshot_s": snapshot_s,
                                     "write_s": now() - t1, "nbytes": nbytes})
            except Exception as e:                   # surfaced on next wait()
                self._err = e

        self._worker = threading.Thread(target=run, daemon=True)
        self._worker.start()

    def _gc(self):
        # retention counts *valid* checkpoints only: a torn newer step must
        # never push the last durable one out of the keep window
        valid = valid_steps(self.path)
        for s in valid[:-self.keep]:
            shutil.rmtree(self.path / f"step_{s:08d}", ignore_errors=True)
        if valid:
            # torn dirs older than the newest durable step are garbage
            all_steps = [int(p.name.split("_")[1])
                         for p in self.path.glob("step_*")
                         if not p.name.endswith(".tmp")]
            for s in all_steps:
                if s < valid[-1] and s not in valid:
                    shutil.rmtree(self.path / f"step_{s:08d}",
                                  ignore_errors=True)
