"""Prefill and decode on a process mesh (gloo ranks on the CPU,
``testing/check_dist_decode.py``) against the JAX package's single-device
``prefill`` and ``decode_step``: llama3-8b's and mixtral's smoke models
from the JAX initialiser's weights, a 12-token prefill into 32 slots, 8
steps at scalar positions, on (2, 2) and (1, 4) meshes; with the cache's
slots cut over `model` (``cache_seq="model"``: the write into the owning
slice, local scores, the pmax/psum merge) and with its kv heads cut (or
whole where kv 2 does not divide over 4).  Each step's logits and the
final caches within f32's limits (``tests/test_torch_serve.py``'s); the
vocab-sharded lookup equal to ``jnp.take``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules as jax_rules
from repro_torch.testing import check_dist_decode as cdd
from repro_torch.testing import train_checks as tc
from repro_torch.testing.subproc import run_ranks
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

MESHES = [(2, 2), (1, 4)]
ARCHS = cdd.SIZES["smoke"][0]


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{pre}.{k}" if pre else k)
    else:
        yield pre, tree


@pytest.fixture(scope="module")
def runs():
    return {(nd, nm): cdd.assemble(run_ranks("repro_torch.testing.check_dist_decode",
                                             nd * nm, str(nd), str(nm), device="cpu",
                                             timeout=300),
                                   nd * nm, "smoke")
            for nd, nm in MESHES}


@pytest.fixture(scope="module")
def want():
    """JAX's logits at the prefill and each step, its final caches, and the
    prompt's embedding rows."""
    out = {}
    _, B, P, W, steps = cdd.SIZES["smoke"]
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch)
        jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tc.smoke_params(arch))
        prompt, nxt = cdd.tokens(cdd.config(arch, "smoke"), "smoke")
        rules = jax_rules(None)
        cache, logits = jlm.prefill(jp, jnp.asarray(prompt.numpy()), jcfg, rules, W)
        lg = [np.asarray(logits)]
        for i in range(steps):
            logits, cache = jlm.decode_step(jp, jnp.asarray(nxt[i].numpy()), cache,
                                            jnp.int32(P + i), jcfg, rules)
            lg.append(np.asarray(logits))
        out[arch] = {"logits": np.stack(lg), "cache": dict(_paths(cache)),
                     "embed": np.asarray(jnp.take(jp["embed"],
                                                  jnp.asarray(prompt.numpy()), axis=0))}
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("cache", cdd.CACHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_a_mesh_matches_jax(runs, want, mesh, cache, arch):
    got, w = runs[mesh][(arch, cache)], want[arch]
    np.testing.assert_allclose(got["logits"].numpy(), w["logits"],
                               rtol=cdd.RTOL, atol=cdd.ATOL)
    caches = dict(_paths(got["cache"]))
    assert set(caches) == set(w["cache"])
    for path, t in caches.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(w["cache"][path]),
                                   rtol=cdd.RTOL, atol=cdd.ATOL, err_msg=path)
    # each rank's calls of the kernels' Functions (its launches on the
    # card): ``serve_launches`` with the mesh, a prefill and 8 steps
    assert all(c == want_c for c, want_c in got["launches"]), got["launches"]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_vocab_sharded_lookup_is_jnp_take(runs, want, mesh, arch):
    np.testing.assert_array_equal(runs[mesh][("embed", arch)].numpy(),
                                  want[arch]["embed"])


def test_per_slot_positions_refuse_the_sharded_cache():
    """The reference's ``NotImplementedError`` for per-slot positions over a
    cache cut over `model` (raised before any collective)."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules

    cfg = cdd.config("llama3-8b", "smoke")
    rules = default_rules(Mesh.abstract((1, 2), ("data", "model")), cache_seq="model")
    cache = L.AttnCache(torch.zeros((2, 16, 2, 16)), torch.zeros((2, 16, 2, 16)))
    with pytest.raises(NotImplementedError, match="per-slot decode positions"):
        L.attn_layer_decode({}, torch.zeros((2, 1, 64)), cache,
                            torch.tensor([3, 4]), cfg, rules=rules)
