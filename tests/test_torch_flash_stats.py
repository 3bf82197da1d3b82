"""The CPU side of the flash-attention backward's ``stats`` kernels
(``csrc/flash_attention_bwd.cu``: ``flash_bwd_dd_kernel`` and the wgmma
kernels' ``<true, D>`` instances, reading the statistics the wgmma forward
keeps under autograd): which calls take them (``bwd_variant``), their
blocks' launch order (``bwd_block_order``, ``bwd_dkv_order``), each held to
hold every block exactly once with a kv head's blocks consecutive; and the
plain forward with its log-sum-exp (``ref.attention_lse``) held to
``torch.logsumexp``, to the JAX reference's scores and to the Pallas
kernel.  The kernels' arithmetic is emulated in
``tests/test_torch_flash_bwd.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

BQ, BK = fa.WGMMA_BQ, fa.WGMMA_BK


@pytest.mark.parametrize("S,Sk,D,dtype,aligned,want", [
    (1024, 6404, 128, torch.bfloat16, True, "stats"),    # vlm cross, train step
    (512, 6404, 128, torch.bfloat16, True, "stats"),     # vlm cross, prefill
    (35, 6404, 128, torch.bfloat16, True, "stats"),
    (4608, 4608, 128, torch.bfloat16, True, "stats"),    # mixtral's long prompt
    (70, fa.STATS_MIN_SK, 64, torch.bfloat16, True, "stats"),
    (70, fa.STATS_MIN_SK, 96, torch.bfloat16, True, "stats"),
    (70, fa.STATS_MIN_SK - 1, 128, torch.bfloat16, True, "wgmma"),
    (1024, 1024, 128, torch.bfloat16, True, "wgmma"),    # the training shape
    (1024, 256, 64, torch.bfloat16, True, "wgmma"),      # seamless cross
    (1024, 6404, 128, torch.float32, True, "tf32x3"),
    (1024, 6404, 128, torch.bfloat16, False, "simt"),
    (1024, 6404, 32, torch.bfloat16, True, "simt")])
def test_the_stats_backward_takes_the_long_key_walks(S, Sk, D, dtype, aligned, want):
    """The rule by Sk; the forward stays the wgmma kernel (or simt, or
    tf32x3 in f32) at every shape, and writes the statistics only for a
    stats backward."""
    assert fa.bwd_variant(S, Sk, D, dtype, aligned) == want
    assert fa.variant(S, Sk, D, dtype, aligned) == (want if want in ("simt", "tf32x3")
                                                    else "wgmma")


@pytest.mark.parametrize("B,Hkv,Sk", [(4, 8, 6404), (1, 8, 37), (2, 16, 256)])
def test_stats_dkv_blocks_run_in_kv_head_order(B, Hkv, Sk):
    """Every (b, kv head, 64-key tile) once, a kv head's tiles consecutive
    and in key order (the first keys, a causal grid's heaviest, first)."""
    order = fa.bwd_dkv_order(B, Hkv, Sk)
    KT = -(-Sk // BK)
    assert sorted(order) == [(b, hk, t * BK) for b in range(B) for hk in range(Hkv)
                             for t in range(KT)]
    for x in range(0, len(order), KT):
        assert [k0 for _, _, k0 in order[x:x + KT]] == [t * BK for t in range(KT)]
        assert len({(b, hk) for b, hk, _ in order[x:x + KT]}) == 1


@pytest.mark.parametrize("B,Hq,Hkv,S", [(4, 32, 8, 1024), (1, 32, 8, 35), (2, 16, 16, 200),
                                        (1, 4, 1, 445)])
def test_stats_dq_blocks_run_in_kv_head_order(B, Hq, Hkv, S):
    """Every (b, q head, 64-row q tile) once; the G x T blocks of a (b, kv
    head) consecutive; within a head the longest walks first."""
    order = fa.bwd_block_order(B, Hq, Hkv, S)
    T, G = -(-S // BQ), Hq // Hkv
    assert sorted(order) == sorted((b, h, t * BQ) for b in range(B) for h in range(Hq)
                                   for t in range(T))
    for x in range(0, len(order), G * T):
        group = order[x:x + G * T]
        assert len({(b, h // G) for b, h, _ in group}) == 1
        for y in range(0, G * T, T):
            assert [q0 for _, _, q0 in group[y:y + T]] == sorted(
                (q0 for _, _, q0 in group[y:y + T]), reverse=True)


def _mask(S, Sk, causal, window):
    i = torch.arange(S)[:, None]
    j = torch.arange(Sk)[None]
    vis = torch.ones((S, Sk), dtype=torch.bool)
    if causal:
        vis &= i >= j
    if window:
        vis &= i - j < window
    return vis


def _smoke(B, S, Sk, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, n, D), dtype=np.float32)
            for n, h in ((S, Hq), (Sk, Hkv), (Sk, Hkv))]


def _jax_lse(q, k, v, causal, window):
    """Each row's log-sum-exp of the JAX reference's masked scaled scores
    (the f32 scores of ``repro.models.layers._sdpa_chunked``)."""
    Hq, Hkv, S, Sk, D = q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3]
    kq = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=1)
    s = jnp.einsum("bhqd,bhtd->bhqt", jnp.asarray(q), kq) * (1.0 / math.sqrt(D))
    qp, kp = jnp.arange(S)[:, None], jnp.arange(Sk)[None]
    mask = jnp.ones((S, Sk), bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    return np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1))


#: the smoke models' heads (4 over 2 of 16; XATTN_FLASH_CASES's last) and
#: at the kernels' head dims: self-attention causal with and without a
#: window, cross-attention, and a window that leaves early rows' keys
LSE_CASES = [(2, 9, 16, 4, 2, 16, False, None), (2, 37, 37, 4, 2, 16, True, None),
             (1, 70, 70, 4, 1, 64, True, 9), (1, 35, 300, 4, 1, 128, False, None),
             (1, 65, 65, 2, 2, 96, True, 1)]


@pytest.mark.parametrize("B,S,Sk,Hq,Hkv,D,causal,window", LSE_CASES, ids=str)
def test_the_plain_l_is_the_logsumexp_of_the_masked_scores(B, S, Sk, Hq, Hkv, D, causal,
                                                           window):
    """``ref.attention_lse``'s L equals ``torch.logsumexp`` of the masked
    scores and the JAX reference's within 1e-5, its output
    ``ref.attention``'s bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _smoke(B, S, Sk, Hq, Hkv, D))
    out, lse = ref.attention_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(out, ref.attention(q, k, v, causal=causal, window=window))
    s = torch.einsum("bhsd,bhtd->bhst", q, ref.expand_kv(k, Hq)) / math.sqrt(D)
    vis = _mask(S, Sk, causal, window)
    want = torch.logsumexp(torch.where(vis, s, -math.inf), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q.numpy(), k.numpy(), v.numpy(),
                                                      causal, window), rtol=1e-5, atol=1e-5)


def test_a_row_with_no_visible_key_has_an_infinite_l():
    """Keys only past S's rows (causal over a context shorter than the
    window's reach is not enough; a window of 1 over Sk < S leaves rows
    past Sk none): L = +inf, so the stats backward's P there is 0."""
    q, k, v = (torch.from_numpy(a) for a in _smoke(1, 6, 3, 2, 1, 16))
    _, lse = ref.attention_lse(q, k, v, causal=True, window=1)
    assert bool(torch.isinf(lse[..., 3:]).all()) and bool(torch.isfinite(lse[..., :3]).all())


@pytest.mark.parametrize("S", [64, 128])
def test_the_plain_output_is_the_pallas_kernels(S):
    """The plain forward beside L is the JAX package's Pallas kernel (run
    as its own tests run it, in interpret mode) on the smoke heads."""
    q, k, v = _smoke(1, S, S, 4, 2, 16, seed=3)
    out, _ = ref.attention_lse(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
