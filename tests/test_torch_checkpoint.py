"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the same on-disk format leaf for leaf, so a train state written
by either restores bit for bit in the other; the same torn-write gate; and
an async save that keeps the state of its step while the next train step
updates the tensors in place.  Twins of ``tests/test_checkpoint.py``'s
cases run on the port's functions, its restore onto a smaller mesh
(``test_restore_onto_smaller_mesh``) among them: a JAX checkpoint of a
leaf placed on a (4, 2) mesh restores onto the port's survivor mesh, and
a save from a (2, 2) process mesh of 4 ranks restores bit for bit onto a
(1, 2) mesh of two of them and in one process
(``testing/check_ckpt_mesh.py``)."""
import dataclasses
import json
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.parallel.sharding import init_params as jax_init
from repro.train import OptConfig as JOptConfig
from repro.train import TrainState as JTrainState
from repro.train import abstract_train_state as jax_abstract_train_state
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.checkpoint import (CheckpointManager, SimulatedCrash,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint, tear_checkpoint,
                                    valid_steps)
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.configs import get_smoke_config
from repro_torch.params import params_from_jax
from repro_torch.testing import train_checks as tc
from repro_torch.train import (OptConfig, TrainState, abstract_train_state,
                               make_train_step)
from repro_torch.train.trainer import init_train_state
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 4), generator=g),
        "b": torch.randn((4,), generator=g),
        "half": torch.randn((4, 4), generator=g).to(torch.bfloat16),
        "step": torch.tensor(3, dtype=torch.int32),
    }


def _assert_trees_equal(got, want):
    g, w = flatten(got), flatten(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_sync_round_trip(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, tree, step=7, extra={"data_cursor": 7})
    got, step, extra = restore_checkpoint(tmp_path, tree, device="cpu")
    assert step == 7
    assert extra == {"data_cursor": 7}
    _assert_trees_equal(got, tree)                 # incl. bf16 leaf bitwise
    assert got["step"].shape == () and list(got) == list(tree)


def test_bf16_bits_round_trip_exactly(tmp_path):
    """Every 16-bit pattern (NaNs, infinities, subnormals and negative zero
    among them) stored as bf16 comes back as the same bits."""
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    tree = {"x": bits.view(torch.bfloat16).reshape(256, 256)}
    d = save_checkpoint(tmp_path, tree, step=0)
    meta = json.loads((d / "manifest.json").read_text())["leaves"][0]
    assert meta["dtype"] == "bfloat16"
    assert np.load(d / "leaf_00000.npy").dtype == np.uint16
    got, _, _ = restore_checkpoint(tmp_path, tree, device="cpu")
    assert torch.equal(got["x"].view(torch.int16), bits.reshape(256, 256))


def test_async_round_trip_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    trees = {s: _tree(seed=s) for s in (1, 2, 3)}
    for s in (1, 2, 3):
        mgr.save_async(trees[s], step=s)
    mgr.wait(timeout=120)
    assert valid_steps(tmp_path) == [2, 3]         # keep=2 pruned step 1
    got, step, _ = restore_checkpoint(tmp_path, trees[3], device="cpu")
    assert step == 3
    _assert_trees_equal(got, trees[3])
    assert [t["step"] for t in mgr.timings] == [1, 2, 3]


def test_manifest_records_leaf_sizes(tmp_path):
    d = save_checkpoint(tmp_path, _tree(), step=0)
    manifest = json.loads((d / "manifest.json").read_text())
    for i, meta in enumerate(manifest["leaves"]):
        assert meta["nbytes"] == (d / f"leaf_{i:05d}.npy").stat().st_size


def test_torn_checkpoint_is_skipped(tmp_path):
    trees = {s: _tree(seed=s) for s in (1, 2)}
    for s in (1, 2):
        save_checkpoint(tmp_path, trees[s], step=s)
    assert latest_step(tmp_path) == 2
    tear_checkpoint(tmp_path, step=2)
    assert valid_steps(tmp_path) == [1]
    assert latest_step(tmp_path) == 1
    got, step, _ = restore_checkpoint(tmp_path, trees[1], device="cpu")
    assert step == 1
    _assert_trees_equal(got, trees[1])
    with pytest.raises(ValueError, match=r"torn.*valid steps: \[1\]"):
        restore_checkpoint(tmp_path, trees[2], step=2, device="cpu")


def test_simulated_crash_leaves_only_tmp(tmp_path):
    save_checkpoint(tmp_path, _tree(seed=1), step=1)
    with pytest.raises(SimulatedCrash):
        save_checkpoint(tmp_path, _tree(seed=2), step=2, crash_after_leaves=1)
    names = sorted(p.name for p in pathlib.Path(tmp_path).glob("step_*"))
    assert names == ["step_00000001", "step_00000002.tmp"]
    assert latest_step(tmp_path) == 1
    save_checkpoint(tmp_path, _tree(seed=2), step=2)
    assert latest_step(tmp_path) == 2


def test_gc_keeps_durable_over_newer_torn(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1)
    for s in (1, 2):
        save_checkpoint(tmp_path, _tree(seed=s), step=s)
    tear_checkpoint(tmp_path, step=2)
    mgr._gc()
    assert valid_steps(tmp_path) == [1]
    save_checkpoint(tmp_path, _tree(seed=3), step=3)
    mgr._gc()
    assert valid_steps(tmp_path) == [3]
    assert not (pathlib.Path(tmp_path) / "step_00000002").exists()


def test_empty_dir_has_no_latest(tmp_path):
    assert latest_step(tmp_path) is None
    assert valid_steps(tmp_path) == []
    assert valid_steps(tmp_path / "missing") == []


def test_truncated_manifest_is_invalid(tmp_path):
    save_checkpoint(tmp_path, _tree(), step=1)
    save_checkpoint(tmp_path, _tree(1), step=2)
    man = tmp_path / "step_00000002" / "manifest.json"
    man.write_bytes(man.read_bytes()[: len(man.read_bytes()) // 2])
    assert valid_steps(tmp_path) == [1]
    assert latest_step(tmp_path) == 1


def test_renamed_but_unsynced_leaf_is_invalid(tmp_path):
    save_checkpoint(tmp_path, _tree(), step=1)
    save_checkpoint(tmp_path, _tree(1), step=2)
    (tmp_path / "step_00000002" / "leaf_00000.npy").write_bytes(b"")
    assert valid_steps(tmp_path) == [1]


def test_after_leaf_hook_sees_durable_prefix(tmp_path):
    tree = _tree()
    seen = []

    def hook(i):
        stage = tmp_path / "step_00000001.tmp"
        leaves = sorted(p.name for p in stage.glob("leaf_*.npy"))
        assert leaves == [f"leaf_{j:05d}.npy" for j in range(i + 1)]
        assert not (stage / "manifest.json").exists()
        assert not list(stage.glob("*.part")), "unpublished temp visible"
        seen.append(i)

    save_checkpoint(tmp_path, tree, step=1, after_leaf=hook)
    assert seen == list(range(len(flatten(tree))))
    assert valid_steps(tmp_path) == [1]


def test_publish_leaves_no_part_turds(tmp_path):
    save_checkpoint(tmp_path, _tree(), step=3)
    assert not list(tmp_path.rglob("*.part"))
    assert not list(tmp_path.glob("*.tmp"))
    got, step, _ = restore_checkpoint(tmp_path, _tree(), device="cpu")
    assert step == 3
    _assert_trees_equal(got, _tree())


def test_restore_refuses_another_tree(tmp_path):
    save_checkpoint(tmp_path, _tree(), step=1)
    with pytest.raises(ValueError, match="tree structure changed"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(8, 4)}, device="cpu")
    bad = dict(_tree(), w=torch.zeros(4, 8))
    with pytest.raises(ValueError, match="stored shape"):
        restore_checkpoint(tmp_path, bad, device="cpu")


# ---------------------------------------------------------------------------
# the torn-write gate against the reference's, on the same directories
# ---------------------------------------------------------------------------

def _clean(d):
    pass


def _torn(d):
    tear_checkpoint(d, step=2)


def _crash(d):
    with pytest.raises(SimulatedCrash):
        save_checkpoint(d, _tree(3), step=3, crash_after_leaves=2)


def _short_manifest(d):
    man = d / "step_00000002" / "manifest.json"
    man.write_bytes(man.read_bytes()[:40])


def _empty_leaf(d):
    (d / "step_00000002" / "leaf_00001.npy").write_bytes(b"")


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fault", [_clean, _torn, _crash, _short_manifest,
                                   _empty_leaf],
                         ids=["clean", "torn-leaf", "simulated-crash",
                              "truncated-manifest", "unsynced-leaf"])
def test_valid_steps_match_jax(tmp_path, writer, fault):
    for s in (1, 2):
        if writer == "port":
            save_checkpoint(tmp_path, _tree(s), step=s)
        else:
            jckpt.save_checkpoint(tmp_path, {
                k: t.float().numpy().astype(jnp.bfloat16)
                if t.dtype == torch.bfloat16 else t.numpy()
                for k, t in _tree(s).items()}, step=s)
    fault(tmp_path)
    assert valid_steps(tmp_path) == jckpt.valid_steps(tmp_path)
    assert latest_step(tmp_path) == jckpt.latest_step(tmp_path)


# ---------------------------------------------------------------------------
# a train state across the two packages
# ---------------------------------------------------------------------------

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _jax_state(jdt):
    """A smoke train state from the JAX initialiser with moments that are
    not zero and step 7."""
    jcfg = dataclasses.replace(jax_smoke_config("llama3-8b"), dtype=jdt)
    jopt = JOptConfig()
    params = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    opt = jax_adamw_init(params, jopt)
    rng = np.random.default_rng(0)
    opt["params"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 1e-3,
                              x.dtype), opt["params"])
    opt["step"] = jnp.asarray(7, jnp.int32)
    return jcfg, jopt, JTrainState(params, opt)


def _port_cfgs(tdt):
    return (dataclasses.replace(get_smoke_config("llama3-8b"), dtype=tdt),
            OptConfig())


def _from_jax(state):
    tree = jax.tree.map(np.asarray, state)
    return TrainState(params_from_jax(tree.params), params_from_jax(tree.opt))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_flatten_order_is_the_jax_order(dt):
    jdt, tdt = DTYPES[dt]
    jcfg, jopt, _ = _jax_state(jdt)
    want = jax.tree.leaves(jax_abstract_train_state(jcfg, jopt))
    got = flatten(abstract_train_state(*_port_cfgs(tdt)))
    assert [tuple(p.shape) for p in got] == [tuple(s.shape) for s in want]
    assert [str(p.dtype)[6:] for p in got] == [str(s.dtype) for s in want]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_jax_checkpoint_restores_in_the_port(tmp_path, dt):
    """A state saved by ``repro.checkpoint`` restores into the port's
    ``abstract_train_state`` bit for bit against ``params_from_jax`` of the
    same tree, its dicts in the port's key order; saved again by the port,
    every file but the manifest is byte-identical."""
    jdt, tdt = DTYPES[dt]
    _, _, state = _jax_state(jdt)
    jckpt.save_checkpoint(tmp_path / "jax", state, step=7, extra={"data_cursor": 7})
    template = abstract_train_state(*_port_cfgs(tdt))
    got, step, extra = restore_checkpoint(tmp_path / "jax", template, device="cpu")
    assert step == 7 and extra == {"data_cursor": 7}
    want = _from_jax(state)
    _assert_trees_equal(got, want)
    assert list(got.params) == list(template.params)
    assert list(got.opt["params"]["embed"]) == ["m", "v"] + (["master"] if dt == "bf16" else [])
    save_checkpoint(tmp_path / "port", got, step=7, extra={"data_cursor": 7})
    jd, td = tmp_path / "jax" / "step_00000007", tmp_path / "port" / "step_00000007"
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    for n in names:
        if n != "manifest.json":
            assert (jd / n).read_bytes() == (td / n).read_bytes(), n
    jm, tm = (json.loads((d / "manifest.json").read_text()) for d in (jd, td))
    assert {k: v for k, v in jm.items() if k != "treedef"} == tm


@pytest.mark.parametrize("dt", list(DTYPES))
def test_port_checkpoint_restores_in_jax(tmp_path, dt):
    """A state saved by the port restores in the JAX package into its
    ``abstract_train_state``, bit for bit."""
    jdt, tdt = DTYPES[dt]
    jcfg, jopt, state = _jax_state(jdt)
    save_checkpoint(tmp_path, _from_jax(state), step=7)
    got, step, _ = jckpt.restore_checkpoint(tmp_path,
                                            jax_abstract_train_state(jcfg, jopt))
    assert step == 7
    g, w = jax.tree.leaves(got), jax.tree.leaves(state)
    assert jax.tree.structure(got) == jax.tree.structure(state)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_unflatten_keeps_the_template_order():
    tree = {"z": 1, "a": {"y": 2, "b": 3}, "m": (4, 5)}
    leaves = flatten(tree)
    assert leaves == [3, 2, 4, 5, 1]
    out = unflatten(tree, [10 * x for x in leaves])
    assert out == {"z": 10, "a": {"y": 20, "b": 30}, "m": (40, 50)}
    assert list(out) == ["z", "a", "m"] and list(out["a"]) == ["y", "b"]
    with pytest.raises(ValueError, match="more leaves"):
        unflatten(tree, leaves + [6])


# ---------------------------------------------------------------------------
# an async save against the in-place update
# ---------------------------------------------------------------------------

def test_save_async_keeps_the_state_of_its_step(tmp_path, monkeypatch):
    """``save_async``, then a train step (``adamw_update`` writes the
    state's tensors in place) before the writer runs: the checkpoint holds
    the state as it was at the save.  The writer is held until the step is
    done, so a snapshot that shared the live tensors' memory would fail."""
    cfg = get_smoke_config("llama3-8b")
    opt_cfg = tc.opt_config(2)
    state = init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(0), "cpu")
    before = [t.detach().clone() for t in flatten(state)]
    go = threading.Event()
    real = ckpt.save_checkpoint

    def held(*a, **k):
        assert go.wait(timeout=60), "the test never released the writer"
        return real(*a, **k)

    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(state, 1)
    tokens = torch.from_numpy(tc.smoke_batches(1)[0]).to(torch.int64)
    state, _ = make_train_step(cfg, opt_cfg)(state, {"tokens": tokens})
    go.set()
    mgr.wait(timeout=120)
    after = flatten(state)
    assert not all(torch.equal(a, b) for a, b in zip(after, before))
    got, step, _ = restore_checkpoint(tmp_path, abstract_train_state(cfg, opt_cfg),
                                      device="cpu")
    assert step == 1
    for g, b in zip(flatten(got), before):
        assert g.dtype == b.dtype and torch.equal(g, b)


# ---------------------------------------------------------------------------
# restore onto another mesh
# ---------------------------------------------------------------------------

def test_restore_onto_smaller_mesh(tmp_path):
    """The reference's case: a tree placed on a (4, 2) mesh of 8 fake
    devices is saved by the JAX package; host 0 (devices 0-3) dies, and
    the port restores it onto the survivor mesh ``rescale_rules`` gives,
    each position's block the slice JAX's ``NamedSharding`` places on the
    device there, the blocks whole again equal to the saved values."""
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding

    from repro.parallel.sharding import PV as JPV
    from repro.parallel.sharding import default_rules as jax_rules
    from repro.parallel.sharding import param_shardings
    from repro_torch.ft import plan_rescale, rescale_rules
    from repro_torch.params import PV
    from repro_torch.parallel.sharding import gather_tree

    jdefs = {"w": JPV((16, 8), jnp.float32, ("fsdp", "model")),
             "b": JPV((8,), jnp.float32, ("model",))}
    defs = {"w": PV((16, 8), torch.float32, ("fsdp", "model")),
            "b": PV((8,), torch.float32, ("model",))}
    big = JMesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    rng = np.random.default_rng(0)
    vals = {k: rng.normal(size=d.shape).astype(np.float32) for k, d in jdefs.items()}
    sh = param_shardings(jdefs, jax_rules(big, batch=8))
    jckpt.save_checkpoint(tmp_path, {k: jax.device_put(vals[k], sh[k]) for k in jdefs},
                          step=5)
    plan = plan_rescale(old_devices=8, lost_hosts=1, devices_per_host=4,
                        mesh_axes=(4, 2), global_batch=8, restore_step=5)
    mesh, rules = rescale_rules(plan, [0], 4, range(8))
    assert mesh.ranks == (4, 5, 6, 7) and mesh.shape == {"data": 2, "model": 2}
    blocks = []
    for r in range(mesh.size):
        got, step, _ = restore_checkpoint(tmp_path, defs, device="cpu", rules=rules,
                                          rank=r)
        assert step == 5
        blocks.append(got)
    small = JMesh(np.array(jax.devices()[4:]).reshape(2, 2), ("data", "model"))
    jr = jax_rules(small, batch=8)
    for k in defs:
        idx = NamedSharding(small, jr.spec(jdefs[k].logical)) \
            .devices_indices_map(jdefs[k].shape)
        for r, dev in enumerate(small.devices.flat):
            np.testing.assert_array_equal(blocks[r][k].numpy(), vals[k][idx[dev]])
    whole = gather_tree(blocks, defs, rules)
    for k in defs:
        np.testing.assert_array_equal(whole[k].numpy(), vals[k])


def test_a_save_from_a_mesh_restores_on_another_mesh_and_one_process():
    """4 ranks on (2, 2) train a step and save; ranks 0 and 1 restore onto
    their own (1, 2) mesh and gather it back: every leaf's crc32 equals
    the file's, as does a one-process restore's."""
    from repro_torch.testing import check_ckpt_mesh
    from repro_torch.testing.subproc import run_ranks

    d = run_ranks("repro_torch.testing.check_ckpt_mesh", check_ckpt_mesh.RANKS,
                  device="cpu", timeout=300)
    out = check_ckpt_mesh.check(d)
    assert out["n_leaves"] == 37 and out["mesh_1x2"] and out["one_process"]
