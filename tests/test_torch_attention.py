"""The port's attention kernels' plain versions (``ref``) and the ``ops``
seam on the CPU against the JAX package's Pallas kernels in interpret mode
and its jnp references, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

# f32: both sides accumulate in f32 and differ only in summation order.
# bf16: each side rounds its f32 result to bf16 once; an order difference
# can flip that rounding by one bf16 ulp (2**-8 relative), so 1e-2.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# -- paged attention ---------------------------------------------------------

BT, NBLK, NB, HKV, D = 8, 6, 20, 2, 16
#: an empty sequence, a whole block, a ragged one, a full table, one token
LENS = (0, 8, 13, 48, 1)


def _paged_case(G: int, dtype: str, seed: int = 0):
    """Seeded q, a model-layout (NB, bt, Hkv, D) pool with block 0 zero,
    and tables that share blocks and hold zero entries inside lengths."""
    rng = np.random.default_rng(seed + G)
    B = len(LENS)
    q = rng.normal(size=(B, HKV, G, D))
    pools = [rng.normal(size=(NB, BT, HKV, D)) for _ in range(2)]
    for p in pools:
        p[0] = 0
    tables = np.zeros((B, NBLK), np.int32)
    for b, n in enumerate(LENS):
        used = -(-n // BT)
        tables[b, :used] = rng.integers(1, NB, used)
    tables[3, 2] = 0                        # the zero block inside a length
    tables[2, :2] = tables[3, :2]           # blocks shared between sequences
    return q, pools, tables, np.asarray(LENS, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_attention_matches_pallas_and_jnp_ref(G, dtype):
    q, pools, tables, lens = _paged_case(G, dtype)
    qj, qt = _pair(q, dtype)
    (kj, kt), (vj, vt) = (_pair(p, dtype) for p in pools)
    # JAX takes (Hkv, NB, bt, D) arrays; the port the model layout's
    # permuted view, read through its strides
    kj, vj = (jnp.transpose(a, (2, 0, 1, 3)) for a in (kj, vj))
    kt, vt = (t.permute(2, 0, 1, 3) for t in (kt, vt))
    assert not kt.is_contiguous()
    tj, lj = jnp.asarray(tables), jnp.asarray(lens)
    tt, lt = torch.from_numpy(tables), torch.from_numpy(lens)
    want = jpa.paged_attention(qj, kj, vj, tj, lj, interpret=True)
    want_ref = jref.paged_attention(qj, kj, vj, tj, lj)
    for got in (ref.paged_attention(qt, kt, vt, tt, lt),
                ops.paged_attention(qt, kt, vt, tt, lt)):
        assert got.dtype == TDT[dtype] and got.shape == q.shape
        _close(got, want, dtype)
        _close(got, want_ref, dtype)
    assert not ops.paged_attention(qt, kt, vt, tt, lt)[0].any()   # lens 0


def test_paged_attention_ignores_blocks_past_the_length():
    """Entries past ceil(lens / bt) are never read: pointing them at other
    blocks changes nothing."""
    q, pools, tables, lens = _paged_case(4, "float32")
    args = [torch.from_numpy(a) for a in (q, *pools)]
    k, v = (t.permute(2, 0, 1, 3) for t in args[1:])
    base = ref.paged_attention(args[0], k, v, torch.from_numpy(tables),
                               torch.from_numpy(lens))
    junk = tables.copy()
    for b, n in enumerate(lens):
        junk[b, -(-n // BT):] = 7
    again = ref.paged_attention(args[0], k, v, torch.from_numpy(junk),
                                torch.from_numpy(lens))
    np.testing.assert_array_equal(base.numpy(), again.numpy())


# -- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(64, None), (40, None), (64, 16),
                                      (32, 5)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (4, 1)])
def test_attention_matches_pallas_and_jnp_ref(Hq, Hkv, S, window, dtype):
    rng = np.random.default_rng(S + Hq * Hkv)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=(2, h, S, 16)), dtype) for h in (Hq, Hkv, Hkv))
    want = jfa.flash_attention(qj, kj, vj, causal=True, window=window,
                               interpret=True)
    want_ref = jref.attention(qj, kj, vj, causal=True, window=window)
    got = ops.attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == TDT[dtype] and got.shape == (2, Hq, S, 16)
    _close(got, want, dtype)
    _close(got, want_ref, dtype)


@pytest.mark.parametrize("window", [None, 6])
def test_attention_non_causal_matches_jnp_ref(window):
    rng = np.random.default_rng(9)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=(1, h, 24, 16)), "float32") for h in (4, 2, 2))
    want = jref.attention(qj, kj, vj, causal=False, window=window)
    _close(ref.attention(qt, kt, vt, causal=False, window=window), want,
           "float32")


def test_attention_takes_strided_views():
    """The model passes (B, S, H, D) activations as transposed views."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 12, h, 16)))
               for h in (4, 2, 2))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    dense = [t.contiguous() for t in views]
    np.testing.assert_array_equal(ops.attention(*views, window=5).numpy(),
                                  ops.attention(*dense, window=5).numpy())


def test_cpu_attention_never_launches():
    ops.reset_launches()
    q = torch.ones(1, 2, 3, 16)
    ops.attention(q, q, q)
    ops.paged_attention(torch.ones(1, 2, 1, 16), torch.zeros(2, 3, 8, 16),
                        torch.zeros(2, 3, 8, 16),
                        torch.zeros(1, 2, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32))
    assert not any(ops.LAUNCHES.values())
