"""The Mamba2 and cross-attention sublayers on a process mesh (gloo ranks on
the CPU, ``testing/check_dist_families.py``) against the JAX package's
single-device layers: mamba2-370m's and jamba's Mamba2 sublayer,
llama-3.2-vision-11b's and seamless-m4t-large-v2's cross-attention
sublayer (smoke size, the JAX initialiser's weights), their heads (and the
context's kv heads) cut over `model` on (1, 2) and (1, 4) meshes: the
prefill's output and cache, a decode step's output and cache, and the
gradient of sum(w * output) with respect to every parameter, x and the
context, within ``SUB_TOL`` = 2e-4 (|d| <= 2e-4 (|want| + max|want|));
and a whole smoke ``forward_train`` of each family on a (2, 2) mesh (the
batch over `data`, ZeRO-3 over `data`, heads over `model`): the loss
within 1e-5 and every gradient leaf within the train checks' limits of
``jax.value_and_grad`` (``train_checks.GRAD_TOL``; jamba's
``START_ONLY`` limit)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.parallel.sharding import default_rules as jax_rules
from repro.parallel.sharding import init_params as jax_init
from repro_torch.testing import check_dist_families as cdf
from repro_torch.testing import train_checks as tc
from repro_torch.testing.subproc import run_ranks
import torch_jax_smoke as J
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

SUB_MESHES = [(1, 2), (1, 4)]
TRAIN_MESH = (2, 2)
RULES = jax_rules(None)


@pytest.fixture(scope="module")
def runs():
    return {(nd, nm): cdf.assemble(run_ranks("repro_torch.testing.check_dist_families",
                                             nd * nm, str(nd), str(nm), device="cpu",
                                             timeout=300), nd * nm)
            for nd, nm in SUB_MESHES + [TRAIN_MESH]}


def _jax_slot(arch):
    li, key = cdf.SLOT[arch]
    w = J.jax_smoke_weights(arch)
    pre = f"period.{li}.{key}."
    return {k[len(pre):]: jnp.asarray(v[0]) for k, v in w.items() if k.startswith(pre)}


@pytest.fixture(scope="module")
def want():
    """The JAX layer's outputs, caches and gradients, a sublayer each arch."""
    out = {}
    for arch in cdf.ARCHS:
        cfg = jax_smoke_config(arch)
        p = _jax_slot(arch)
        ins = {k: jnp.asarray(v) for k, v in cdf.inputs(arch).items()}
        if cdf.is_mamba(arch):
            o, (conv, state) = JL.mamba_layer(p, ins["x"], cfg, RULES, return_state=True)
            cache = {"conv": conv, "state": state}
            o1, c1 = JL.mamba_layer_decode(p, ins["x1"], JL.MambaCache(conv, state),
                                           cfg, RULES)
            gp, gx = jax.grad(lambda p, x: jnp.sum(
                ins["w"] * JL.mamba_layer(p, x, cfg, RULES)), argnums=(0, 1))(p, ins["x"])
            grads = {**gp, "x": gx}
        else:
            o = JL.xattn_layer(p, ins["x"], ins["ctx"], cfg, RULES)
            c = JL.xattn_prefill_cache(p, ins["ctx"], cfg)
            cache = {"k": c.k, "v": c.v}
            o1, c1 = JL.xattn_layer_decode(p, ins["x1"], c, cfg, RULES)
            gp, gx, gc = jax.grad(lambda p, x, ctx: jnp.sum(
                ins["w"] * JL.xattn_layer(p, x, ctx, cfg, RULES)),
                argnums=(0, 1, 2))(p, ins["x"], ins["ctx"])
            grads = {**gp, "x": gx, "ctx": gc}
        out[arch] = {"out": o, "out1": o1, "cache": cache, "cache1": c1._asdict(),
                     "grads": grads}
    return out


def _use(got, w) -> float:
    return cdf.limit_use(got, torch.from_numpy(np.array(w, np.float32)))


@pytest.mark.parametrize("mesh", SUB_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", cdf.ARCHS)
def test_sublayer_prefill_and_decode_match_jax(runs, want, mesh, arch):
    got, w = runs[mesh][arch], want[arch]
    assert got["same_out_on_every_rank"]
    assert _use(got["out"], w["out"]) <= 1.0
    assert _use(got["out1"], w["out1"]) <= 1.0
    for k in w["cache"]:
        assert _use(got["cache"][k], w["cache"][k]) <= 1.0, k
        assert _use(got["cache1"][k], w["cache1"][k]) <= 1.0, k


@pytest.mark.parametrize("mesh", SUB_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", cdf.ARCHS)
def test_sublayer_gradients_match_jax(runs, want, mesh, arch):
    got, w = runs[mesh][arch]["grads"], want[arch]["grads"]
    assert set(got) == set(w)
    for k in w:
        assert _use(got[k], w[k]) <= 1.0, k


@pytest.mark.parametrize("arch", cdf.ARCHS)
def test_forward_train_on_a_mesh_matches_jax_grad(runs, arch):
    jcfg = jax_smoke_config(arch)
    toks, ctx = cdf.train_inputs(arch)
    jp = jax_init(jlm.model_defs(jcfg), jax.random.key(0))
    jl, jg = jax.value_and_grad(lambda p: jlm.forward_train(
        p, jnp.asarray(toks.numpy()), jcfg, RULES,
        None if ctx is None else jnp.asarray(ctx.numpy())))(jp)
    got = runs[TRAIN_MESH][arch]
    assert all(abs(l - float(jl)) <= tc.SCALAR_RTOL * abs(float(jl)) for l in got["loss"])
    rtol, share = tc.START_ONLY.get(arch, tc.GRAD_TOL)
    want = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    flat = dict(J._paths(got["train_grads"]))
    assert set(flat) == set(want)
    for path, g in flat.items():
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=share * np.abs(w).max(), err_msg=path)


def test_the_mamba_cut_follows_the_heads():
    """On (1, 4) mamba2-370m's smoke sublayer (8 heads of 16): a rank's 2
    heads, its 32 x channels, B and C whole, its block of the SSM state
    and of the conv window's 160 channels."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules, local_shape, param_placements

    cfg = get_smoke_config("mamba2-370m")
    mesh = Mesh.abstract((1, 4), ("data", "model"))
    rules = default_rules(mesh, fsdp=False)
    specs = param_placements(L.mamba_defs(cfg), rules)
    defs = L.mamba_defs(cfg)
    shapes = {k: local_shape(pv.shape, specs[k], mesh) for k, pv in defs.items()}
    assert shapes["A_log"] == (2,) and shapes["gnorm"] == (32,)
    assert shapes["out_proj"] == (32, 64) and shapes["conv_w"] == (4, 40)
    cache = L.mamba_cache_defs(cfg, 2)
    cspecs = param_placements(cache._asdict(), rules)
    assert local_shape(cache.state.shape, cspecs["state"], mesh) == (2, 2, 16, 16)
    assert local_shape(cache.conv.shape, cspecs["conv"], mesh) == (2, 3, 40)
    p = {"A_log": torch.zeros(2)}
    mesh.rank = 3
    hs = L.mamba_heads(p, cfg, rules, "cpu")
    assert (hs.h0, hs.n) == (6, 2)
    assert hs.channels.tolist() == list(range(96, 128)) + list(range(128, 160))


def test_shard_tree_places_in_the_defs_order():
    """``GradSync`` reads a gradient's leaves in ``lm.model_defs``' order:
    a whole tree in another key order (the smoke weights' file is sorted:
    ``A_log`` before ``norm``) comes back from ``shard_tree`` and
    ``place_tree`` in the defs' order, so each leaf is summed over its own
    dimensions (before, mamba2's ``D`` took another leaf's)."""
    from repro_torch.models import lm
    from repro_torch.parallel.comm import Mesh
    from repro_torch.parallel.sharding import default_rules, place_tree, shard_tree
    from repro_torch.testing.check_dist_train import flat

    cfg = cdf.config("mamba2-370m")
    defs = lm.model_defs(cfg)
    whole = tc.smoke_params("mamba2-370m")
    assert list(flat(whole)) != list(flat(defs))
    rules = default_rules(Mesh.abstract((2, 2), ("data", "model")), batch=4)
    for placed in (shard_tree(whole, defs, rules, 3), place_tree(whole, defs, rules)):
        assert list(flat(placed)) == list(flat(defs))
