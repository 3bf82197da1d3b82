"""The paper's Table I kernels on the CPU (the port's plain versions, which
the seam takes for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs, and the ``kern`` benchmark twin.

Tolerances, each with its reason:
  * jacobi2d f32, expv f32 and ``combine_partials``: the same f32
    operations in the same order, each rounded once (the plain expv
    emulates the kernel's fused multiply-adds): bit-identical;
  * expv bf16: the same f32 result rounded once to bf16 on each side: at
    most one bf16 ulp (0 expected);
  * fconv2d: both sum fr*fc f32 taps in one order, the TPU kernel possibly
    by fused multiply-adds, the plain version by a product and an add: the
    JAX test's rtol = atol = 2e-4 would allow ~50x the ~4e-6 they differ
    by at 7x7; 2e-5 keeps 5x;
  * dotprod, dotprod_hier and the lane partials: each side's f32 sum
    against the f64 sum of the products, and the port's against the JAX
    kernel's directly, within ``kernel_checks.dot_bound`` (six standard
    deviations of an f32 sum's rounding error) at a chain of the vector's
    length, which no f32 sum of it exceeds: twice that between the two
    sides.  About 1e-6 of sum|a b| at these sizes: a dropped product or a
    lane slice shifted by a few elements moves a sum by more;
  * the dot checks' own limit at the card's chains rejects dots that round
    products or inputs to bf16 (``kernel_checks.dot_controls``);
  * softmax_rows: the exponentials and the row sums of the two sides
    differ by a few f32 ulp (measured 4.5e-7 relative at (32, 1024)):
    rtol 1e-5, atol 1e-6 (the JAX test's), and rows summing to 1 within
    1e-5; masked (-inf) elements give 0 on both sides.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import reduction as jred
from repro_torch.kernels import ops, reduction, ref, stencil
from repro_torch.launch import kern
from repro_torch.testing import kernel_checks as kc
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)

HIERARCHIES = ["two-level", "flat"]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("hw", [(16, 256), (8, 512), (24, 128), (13, 37)])
def test_jacobi2d_equals_pallas_bit_for_bit(hw):
    x = np.random.default_rng(hw[0] * hw[1]).normal(size=hw).astype(np.float32)
    want = jops.jacobi2d(jnp.asarray(x), use_pallas=True)
    got = ops.jacobi2d(torch.from_numpy(x))
    assert got.shape == hw and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("f", [(7, 7), (3, 3), (5, 3)])
def test_fconv2d_matches_pallas(f):
    rng = np.random.default_rng(f[0] * 10 + f[1])
    x = rng.normal(size=(16 + f[0] - 1, 256 + f[1] - 1)).astype(np.float32)
    filt = rng.normal(size=f).astype(np.float32)
    want = jops.fconv2d(jnp.asarray(x), jnp.asarray(filt), use_pallas=True)
    got = ops.fconv2d(torch.from_numpy(x), torch.from_numpy(filt))
    assert got.shape == (16, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def _f64_dot(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """The exact-enough sum, and the bound of an f32 sum of the products
    whose chains are at most the vector's length."""
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = (ta.double() * tb.double()).sum().item()
    return exact, kc.dot_bound(ta, tb, len(a))


@pytest.mark.parametrize("n", [16384, 8 * 2048 * 3, 5000])
def test_dotprod_within_its_bound_of_the_f64_sum(n):
    rng = np.random.default_rng(n)
    a, b = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    exact, bound = _f64_dot(a, b)
    got = ops.dotprod(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == () and got.dtype == torch.float32
    assert abs(got.item() - exact) <= bound
    jax_got = float(jops.dotprod(jnp.asarray(a), jnp.asarray(b), use_pallas=True))
    assert abs(jax_got - exact) <= bound
    assert abs(got.item() - jax_got) <= 2 * bound


@pytest.mark.parametrize("hierarchy", HIERARCHIES)
@pytest.mark.parametrize("C,L", [(4, 2), (2, 4), (3, 5)])
def test_dotprod_hier_within_its_bound_of_the_f64_sum(C, L, hierarchy):
    rng = np.random.default_rng(C * 10 + L)
    a, b = (rng.normal(size=5000).astype(np.float32) for _ in range(2))
    exact, bound = _f64_dot(a, b)
    got = ops.dotprod_hier(torch.from_numpy(a), torch.from_numpy(b), C=C, L=L,
                           hierarchy=hierarchy)
    assert got.shape == () and abs(got.item() - exact) <= bound
    jax_got = float(jops.dotprod_hier(jnp.asarray(a), jnp.asarray(b), C=C, L=L,
                                      hierarchy=hierarchy, use_pallas=True))
    assert abs(jax_got - exact) <= bound
    assert abs(got.item() - jax_got) <= 2 * bound


@pytest.mark.parametrize("n,C,L,block", [(5000, 3, 5, 256), (30000, 4, 2, 256),
                                         (70000, 2, 2, 64)])
def test_lane_partials_match_the_jax_lanes(n, C, L, block):
    """Lane i's partial over its slice of the input zero-padded to a
    multiple of C*L*8*block, against the JAX kernel run on that slice, as
    the JAX ``dotprod_hier`` runs it."""
    rng = np.random.default_rng(n + C)
    a, b = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    S = reduction.lane_len(n, C, L, block)
    ap, bp = (np.pad(v, (0, S * C * L - n)) for v in (a, b))
    want = [float(jred.dotprod(jnp.asarray(ap[i * S:(i + 1) * S]),
                               jnp.asarray(bp[i * S:(i + 1) * S]), block=block,
                               interpret=True)) for i in range(C * L)]
    got = ref.lane_dots(torch.from_numpy(a), torch.from_numpy(b), S, C * L)
    assert got.shape == (C * L,) and got.dtype == torch.float32
    for i in range(C * L):
        lane = slice(i * S, (i + 1) * S)
        bound = kc.dot_bound(torch.from_numpy(ap[lane]), torch.from_numpy(bp[lane]), S)
        assert abs(got[i].item() - want[i]) <= 2 * bound, (i, got[i], want[i])


@pytest.mark.parametrize("n", [4096, 4099, 2 ** 16])
def test_dot_check_rejects_dots_that_round_to_bf16(n):
    """At the chains the kernels are held to, a dot that rounds products or
    inputs to bf16 reads above the limit, and the plain f32 sum below."""
    a, b = kc.vec_inputs(n, torch.float32, "cpu")
    for chain in (kc.dot_chain(n), kc.hier_chain(n, 16, 4)):
        got = ref.dotprod(a, b)
        assert kc.compare_dot(got, got, a, b, chain)["ok"]
        controls = kc.dot_controls(a, b, chain)
        assert set(controls) == {"bf16 products", "bf16 inputs"}
        for r in controls.values():
            assert not r["ok"] and r["limit_use"] > 1


@pytest.mark.parametrize("hierarchy", HIERARCHIES)
@pytest.mark.parametrize("C,L", [(4, 2), (2, 4), (3, 5), (16, 4)])
def test_combine_partials_equals_jax_bit_for_bit(C, L, hierarchy):
    parts = np.random.default_rng(C * L).normal(size=C * L).astype(np.float32)
    want = jred.combine_partials(jnp.asarray(parts), C, L, hierarchy)
    got = reduction.combine_partials(torch.from_numpy(parts), C, L, hierarchy)
    assert _bits(got.numpy()) == _bits(want)


def test_combine_partials_keeps_trailing_dims_and_refuses_bad_input():
    parts = np.random.default_rng(7).normal(size=(15, 3)).astype(np.float32)
    want = jred.combine_partials(jnp.asarray(parts), 3, 5, "two-level")
    got = reduction.combine_partials(torch.from_numpy(parts), 3, 5)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    with pytest.raises(ValueError, match="lanes"):
        reduction.combine_partials(torch.zeros(6), 3, 5)
    with pytest.raises(ValueError, match="hierarchy"):
        reduction.combine_partials(torch.zeros(15), 3, 5, "ring")


@pytest.mark.parametrize("n,C,L,block", [(5000, 3, 5, 256), (70000, 2, 2, 64)])
def test_lane_slices_follow_the_jax_padding_quantum(n, C, L, block):
    """Lane i holds elements [i*S, (i+1)*S) of the input zero-padded to a
    multiple of C*L*8*block: the JAX wrapper's slices."""
    S = reduction.lane_len(n, C, L, block)
    quantum = C * L * 8 * block
    assert S * C * L == -(-n // quantum) * quantum


def test_expv_equals_pallas_bit_for_bit_f32():
    x = np.random.default_rng(0).uniform(-100, 100, 16384).astype(np.float32)
    want = jops.expv(jnp.asarray(x), use_pallas=True)
    got = ops.expv(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_expv_equals_pallas_bit_for_bit_at_the_round_half_edges():
    """Within 64 ulps of (n + 1/2) ln 2 for every n in [-116, 116], where
    k = round(x / ln2) turns, and at +-80, +-inf and NaN.  The reference's
    x / ln2 is compiled by XLA as a product with the f32 reciprocal; an
    IEEE quotient rounds 34 of these inputs to the other k, 2-3 ulps off."""
    x = kc.expv_edge_inputs("cpu").numpy()
    want = np.asarray(jops.expv(jnp.asarray(x), use_pallas=True))
    got = ops.expv(torch.from_numpy(x)).numpy()
    nan = np.isnan(x)
    assert nan.sum() == 1 and np.isnan(want[nan]).all() and np.isnan(got[nan]).all()
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


# case: (ulps added to element 1, a NaN in `got` at element 2;
#        then differ, nan_mismatch, ulps, ok as bit_diff should read them)
_BIT_DIFF_CASES = {
    "same": (0, False, 0, 0, 0, True),
    "one ulp": (1, False, 1, 0, 1, True),
    "two ulps": (2, False, 1, 0, 2, False),
    "nan on one side": (0, True, 1, 1, 0, False),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(_BIT_DIFF_CASES))
def test_bit_diff_reads_the_sweep_rule(case, dtype):
    """``kernel_checks.bit_diff``, which the sweep of every expv input
    reads: a NaN equals a NaN, a NaN on one side only fails, one ulp
    passes and two fail."""
    step, nan_one_side, differ, nan_mismatch, ulps, ok = _BIT_DIFF_CASES[case]
    want = torch.tensor([1.0, 2.5, 3.0, math.nan], dtype=dtype)
    got = want.clone()
    got.view(torch.int32 if dtype == torch.float32 else torch.int16)[1] += step
    if nan_one_side:
        got[2] = math.nan
    r = kc.bit_diff(got, want)
    assert (r["n"], r["differ"], r["nan_mismatch"], r["ulps"], r["ok"]) == (
        4, differ, nan_mismatch, ulps, ok)


def _dot_chain_pr15(seg_len: int, nseg: int = 1) -> int:
    """The dot chain as the kernel before the one-block path counted it:
    every segment paid the last block's pass."""
    want = max(1, math.ceil(seg_len / (256 * 16)))
    bps = min(want, max(1, 132 * 8 // nseg))
    per_thread = math.ceil(seg_len / (bps * 256 * 8)) * 8 + 1
    return per_thread + 10 + math.ceil(bps / 256) + 10


# every dotprod length and (n, C, L) that the checks use: TABLE1, RAGGED,
# the gpu tests and this file's
DOT_NS = sorted({cfg["dot"] for cfg in kc.TABLE1.values()} | set(kc.RAGGED["dot"])
                | {8, 16, 100, 4099, 4100, 5000, 16384, 8 * 2048 * 3, 2 ** 16, 70000})
HIER_NLC = sorted({(cfg["dot"], C, L) for cfg in kc.TABLE1.values()
                   for C, L in cfg["hier"]}
                  | {(4099, 16, 4), (5000, 3, 5), (70000, 8, 8), (100, 4, 2),
                     (4096, 16, 4)})


@pytest.mark.parametrize("n", DOT_NS)
def test_dot_chain_is_no_longer_than_before(n):
    """The bound ``compare_dot`` holds a dot to grows with the chain: it
    must not loosen.  One-block segments lose the last block's pass."""
    seg = max(8, -(-n // 8) * 8)
    assert kc.dot_chain(n) <= _dot_chain_pr15(seg)
    if reduction.dot_blocks(seg) == 1:
        assert kc.dot_chain(n) == _dot_chain_pr15(seg) - 11
    else:
        assert kc.dot_chain(n) == _dot_chain_pr15(seg)


@pytest.mark.parametrize("n,C,L", HIER_NLC)
def test_hier_chain_is_no_longer_than_before(n, C, L):
    S = reduction.lane_len(n, C, L)
    old = _dot_chain_pr15(S, C * L) + 2 * (C * L).bit_length()
    assert kc.hier_chain(n, C, L) <= old


def test_expv_bf16_within_one_ulp_of_pallas():
    x = np.random.default_rng(1).uniform(-100, 100, 16384).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jops.expv(xj, use_pallas=True).astype(jnp.float32))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = ops.expv(xt)
    assert got.dtype == torch.bfloat16
    # positive bf16 values: the top 16 bits of the f32 pattern, in order
    ulps = np.abs((_bits(got.float().numpy()) >> 16) - (_bits(want) >> 16))
    assert ulps.max() <= 1


@pytest.mark.parametrize("rw", [(8, 512), (5, 300), (3, 5000)])
def test_softmax_rows_masked_matches_pallas(rw):
    x = kc.softmax_inputs(*rw, torch.float32, "cpu", masked=True).numpy()
    want = np.asarray(jops.softmax_rows(jnp.asarray(x), use_pallas=True))
    got = ops.softmax_rows(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all() and (got[np.isneginf(x)] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.astype(np.float64).sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("rw", [(8, 512), (32, 1024), (16, 128), (5, 300)])
def test_softmax_rows_matches_pallas(rw):
    x = (np.random.default_rng(rw[1]).normal(size=rw) * 4).astype(np.float32)
    want = jops.softmax_rows(jnp.asarray(x), use_pallas=True)
    got = ops.softmax_rows(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.double().sum(-1).numpy(), 1.0, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launches()
    v, g = torch.ones(64), torch.ones(8, 8)
    ops.dotprod(v, v)
    ops.dotprod_hier(v, v, C=2, L=2)
    ops.expv(v)
    ops.softmax_rows(g)
    ops.jacobi2d(g)
    ops.fconv2d(g, torch.ones(3, 3))
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("call", [
    lambda: reduction.dotprod(torch.ones(8), torch.ones(8)),
    lambda: reduction.lane_partials(torch.ones(8), torch.ones(8), C=2, L=2),
    lambda: reduction.expv(torch.ones(8)),
    lambda: reduction.softmax_rows(torch.ones(2, 8)),
], ids=["dotprod", "dotprod_hier", "expv", "softmax_rows"])
def test_reduction_kernels_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize("call", [
    lambda: stencil.jacobi2d(torch.ones(4, 4)),
    lambda: stencil.fconv2d(torch.ones(6, 6), torch.ones(3, 3)),
], ids=["jacobi2d", "fconv2d"])
def test_stencil_kernels_refuse_cpu_tensors(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_softmax_checks_take_both_kernel_branches():
    """The softmax checks (phase 3b, the gpu tests) reach both branches of
    ``softmax_plan`` in both dtypes: rows in registers, and rows streamed
    twice, aligned and not."""
    assert kc.RAGGED["softmax_masked"] == kc.RAGGED["softmax"]
    shapes = kc.RAGGED["softmax"] + [rw for cfg in kc.TABLE1.values()
                                     for rw in cfg["softmax"]]
    for item in (4, 2):
        plans = {rw: reduction.softmax_plan(rw[1], item, rw[1] * item % 16 == 0)
                 for rw in shapes}
        assert {p.branch for p in plans.values()} == {"regs", "stream"}
        assert plans[(64, 4096)].branch == plans[(7, 1000)].branch == "regs"
        assert plans[(32768, 8192)].branch == "regs"
        assert plans[(200, 40000)].branch == "stream"
        assert plans[(3, 300001)].branch == "stream"          # not aligned
        assert plans[(256, 2 ** 20)].branch == "stream"


def _plan_shapes():
    """(R, W, itemsize) at the branches' edge and beyond: the longest row in
    registers and one vector more, rows of one element and of one vector,
    a few long rows and many short ones, rows that are not whole vectors,
    and table1's."""
    out = []
    for item in (4, 2):
        V = 16 // item
        regs = reduction.SOFTMAX_REG_VECS * reduction.SOFTMAX_MAX_THREADS * V
        out += [(R, W, item) for R, W in (
            (1, 1), (5, V), (64, regs), (64, regs + V), (200, 40000),
            (200, 40000 + 1), (1, 2 ** 16), (3, 300001), (131, 40000),
            (256, 2 ** 20), (4, 2 ** 22), (2 ** 20, 16), (7, 1000))]
    return out


@pytest.mark.parametrize("R,W,item", _plan_shapes(), ids=str)
def test_softmax_plan_stays_within_hopper_limits(R, W, item):
    """Every plan is one block a row within what a Hopper block takes: at
    most 1,024 threads in whole warps; the regs branch aligned rows of at
    most ``SOFTMAX_REG_VECS`` vectors a thread, in as few warps as hold
    them; every other row streamed by 1,024 threads."""
    V = 16 // item
    for aligned in (True, False) if W * item % 16 == 0 else (False,):
        p = reduction.softmax_plan(W, item, aligned)
        assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
        in_regs = aligned and -(-W // V) <= reduction.SOFTMAX_REG_VECS * 1024
        assert p.branch == ("regs" if in_regs else "stream")
        if p.branch == "regs":
            assert -(-W // V) <= reduction.SOFTMAX_REG_VECS * p.threads
            assert -(-W // V) > reduction.SOFTMAX_REG_VECS * (p.threads - 32)
        else:
            assert p.threads == 1024


def test_kern_twin_prints_its_three_rows(capsys):
    kern.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# kern on cpu")
    names = [ln.split(",")[0] for ln in lines[1:]]
    assert names == ["kern/matmul_256", "kern/softmax_rows", "kern/flash_attn"]
    for ln in lines[1:]:
        _, us, plain = ln.split(",")
        assert float(us) > 0 and plain.startswith("plain=") and plain.endswith("us")


# -- fconv2d's plan and refusals (CPU side) ---------------------------------------

def _conv_plan_shapes():
    """(H, W, fr, fc, itemsize): table1's two in both dtypes, the ragged
    checks', every filter side at its edges (1 and 16, square and not), one
    output element, and a wide grid of the largest filter."""
    return [(8192, 8192, 7, 7, 4), (8192, 8192, 7, 7, 2), (250, 4090, 7, 7, 4),
            (250, 4090, 7, 7, 2), (70, 517, 3, 3, 4), (70, 517, 7, 7, 2),
            (1, 1, 1, 1, 4), (1, 1, 16, 16, 2), (33, 129, 16, 1, 4), (33, 129, 1, 16, 2),
            (100, 1001, 5, 5, 2), (3, 3, 12, 5, 4), (40000, 40000, 16, 16, 4)]


@pytest.mark.parametrize("H,W,fr,fc,item", _conv_plan_shapes(), ids=str)
def test_conv_plan_stays_within_hopper_limits(H, W, fr, fc, item):
    """Every plan unrolls only the square 3, 5 and 7 filters; stages rows
    in a stride of whole 16-byte blocks that holds a row's copies (the last
    may reach to the end of the 16 bytes that hold its last element) and the
    last lane's window; needs
    at most the 227 KB of shared memory a block may have; and runs a
    persistent grid of as many blocks as fit the H100's 132 SMs at once (at
    most four an SM, each with its share of the SM's 228 KB), no more than
    tiles: four an SM at every unrolled filter."""
    p = stencil.conv_plan(H, W, fr, fc, item)
    assert p.variant == (fr if fr == fc and fr in (3, 5, 7) else 0)
    assert p.tiles == -(-H // 32) * -(-W // 128)
    assert p.smem <= 232448
    per_sm = min(4, 233472 // (p.smem + 1024))
    assert per_sm >= (4 if p.variant else 3)
    assert p.grid == max(1, min(p.tiles, per_sm * 132))
    fcm = fc if p.variant else 16
    sw = (p.smem - (0 if p.variant else 1024)) // (2 * item * (32 + fr - 1))
    assert p.smem == 2 * item * (32 + fr - 1) * sw + (0 if p.variant else 1024)
    assert sw * item % 16 == 0
    assert sw * item >= -(-(128 + fcm - 1) * item // 16) * 16           # a row's copies
    assert sw >= 124 + -(-(3 + fcm) // 4) * 4                           # the last lane's reads


@pytest.mark.parametrize("call,err,match", [
    (lambda: stencil.fconv2d(torch.ones(6, 6, dtype=torch.float16), torch.ones(3, 3)),
     TypeError, "f32 or bf16"),
    (lambda: stencil.fconv2d(torch.ones(6, 6).t()[:, :5], torch.ones(3, 3)),
     ValueError, "contiguous"),
    (lambda: stencil.fconv2d(torch.ones(40, 40), torch.ones(17, 3)), ValueError, "taps"),
    (lambda: stencil.fconv2d(torch.ones(40, 40), torch.ones(3, 0)), ValueError, "taps"),
    (lambda: stencil.fconv2d(torch.ones(40, 40), torch.ones(3, 3, 1)), ValueError,
     r"\(fr, fc\)"),
    (lambda: stencil.jacobi2d(torch.ones(2, 4, 4)), ValueError, r"\(H, W\)"),
    (lambda: stencil.jacobi2d(torch.ones(4, 4, dtype=torch.int32)), TypeError, "f32"),
], ids=["f16", "strided", "17 taps", "0 taps", "3-d filter", "3-d grid", "int32"])
def test_stencil_wrappers_refuse_what_they_do_not_take(call, err, match):
    """The stencil wrappers' checks come before their device check, so they
    hold here on CPU tensors; nothing launches."""
    from repro_torch.kernels import launches
    launches.reset()
    with pytest.raises(err, match=match):
        call()
    with pytest.raises(RuntimeError, match="no backward"):
        stencil.fconv2d(torch.ones(6, 6, requires_grad=True), torch.ones(3, 3))
    assert not any(launches.LAUNCHES.values())
