"""The launch-plan autotuner, retargeted at Hopper.

The port's counterpart of ``repro.kernels.autotune``.  A TPU kernel's
tunable is its Pallas block shape; a Hopper kernel's block shapes are fixed
in its CUDA source, and what its wrapper picks from shapes is its launch
plan.  Per problem signature ``(kernel, shape, dtype, topology_tag)`` (the
tag is the card's name) the loop is the reference's:

1. **enumerate** the legal plans of the family (:func:`enumerate_candidates`):
   the matmul's split count (``matmul.split_plan`` for the ``decode``
   kernel, ``matmul.wgmma_plan`` for ``wgmma``), paged attention's pool
   block ``bt`` and its split count (``paged_attention.plan``), rmsnorm's
   backward blocks (``rmsnorm.bwd_blocks``), dotprod's blocks
   (``reduction.dot_blocks``), flash attention's ``variant`` where both
   kernels take the call, and jacobi2d's one launch; each filtered by the
   card's limits (``kernels.hopper``); a family with one legal plan has
   that plan as its only candidate;
2. **rank** them with a Hopper cost model (:func:`model_cost`): the larger
   of the bytes over HBM's rate and the operations over the peak of the
   kind of unit the plan runs on, divided by the share of the SMs its
   blocks occupy, plus a charge a wave of blocks and a charge a further
   split (``matmul.wgmma_plan``'s rule, carried to every family);
3. **measure** the model's top-k on the card (``testing.timing.measure_us``:
   CUDA events, median and IQR, a noisy sample measured again at double
   the reps; the calls rotate through copies of the operands that hold
   twice the L2, so each reads them from HBM, as the main path reads a
   layer's weights), each candidate's output held to its plain version at
   ``testing.kernel_checks``' tolerance: a candidate that fails raises;
4. **cache** the winner in a JSON table of the reference's format
   (``{"schema": 1, "entries": {signature: record}}``, the same record
   keys), which the wrappers read through :func:`tuned_config`.

**No table is read by default.**  Unlike the reference, whose default
context reads ``results/autotune/cache.json`` (an RVV/TPU table that means
nothing on this card), the default context here has no table: the wrappers
read one only inside ``with tuned(path):`` (or in the CLI's ``--cache``).
Outside those every plan is the wrapper's own rule, so the main path's
bits are those of a run without the autotuner; the default context's table
is read-only, and :func:`autotune` refuses to run without a context of its
own.  A table file that is not one raises, and so does a winner that is
not a legal plan of its signature (:func:`is_legal`, which asks the kernel
modules: each states its blocks and legal plans beside its plan rule).  A plan is a function of
the shapes and the table, so the same shapes under one table still give
the same bits twice, and paged decode still equals dense.  A split-K or
flash-decoding plan changes the order of f32 sums, so a tuned result is
held to the untuned one within tolerance, not to the bit (on the CPU the
plain versions take no plan, and the two agree bit for bit).

    PYTHONPATH=src python -m repro_torch.kernels.autotune [--kernel matmul] [--smoke] [--top-k 3] [--reps 5] [--cache build/autotune/cache.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import types

from . import hopper

#: the tunable kernel families (the reference's six names) and their
#: knobs; ``None`` is the wrapper's own rule for the shape
#: (:func:`default_config` gives the plan it takes); jacobi2d's launch has
#: no knob (its tile is fixed in its source), so its one plan is empty
DEFAULTS: dict[str, dict] = {
    "matmul": {"splits": None},
    "flash_attention": {"variant": None},
    "paged_attention": {"bt": 16, "splits": None},
    "rmsnorm": {"bwd_blocks": None},
    "reduction": {"blocks": None},
    "stencil": {},
}
KERNELS = tuple(DEFAULTS)

#: problem-shape conventions, the reference's:
#:   matmul           (M, K, N); the backward's products (M, K, N, trans),
#:                    trans 1 (dA = dC B^T) or 2 (dB = A^T dC)
#:   flash_attention  (B, Hq, Hkv, S, Sk, D), causal
#:   paged_attention  (B, Hq, Hkv, T, D)  -- T = max tokens (nblk * bt)
#:   rmsnorm          (R, D)
#:   reduction        (n,)
#:   stencil          (H, W)

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}

#: the cost model's charges: a wave of blocks over the SMs (launch, fill
#: and tail), and each split past the first of a family other than the
#: wgmma matmul (its partials' traffic is in the bytes); the wgmma matmul's
#: is ``matmul.WGMMA_SPLIT_US``, as ``wgmma_plan`` charges it
WAVE_US = 1.0
SPLIT_US = 1.0


def _itemsize(dtype: str) -> int:
    return _ITEMSIZE.get(str(dtype).replace("torch.", ""), 4)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _torch_dtype(dtype):
    import torch
    return getattr(torch, _dtype_name(dtype))


def signature(kernel: str, shape, dtype: str, topology_tag: str) -> str:
    return "|".join((kernel, "x".join(str(int(s)) for s in shape),
                     _dtype_name(dtype), topology_tag))


def _mm_dims(shape) -> tuple[int, int, int, int]:
    M, K, N = (int(s) for s in shape[:3])
    return M, K, N, int(shape[3]) if len(shape) > 3 else 0


# ---------------------------------------------------------------- candidates

def default_config(kernel: str, shape, dtype: str) -> dict:
    """The plan the wrapper takes for this signature with no table."""
    from . import flash_attention as fa
    from . import matmul as mm
    from . import paged_attention as pa
    from . import reduction as red
    from . import rmsnorm as rms

    if kernel == "matmul":
        M, K, N, trans = _mm_dims(shape)
        kind = mm.variant(M, K, N, _torch_dtype(dtype), trans=trans)
        return {"splits": mm.default_plan(kind, M, K, N, trans)[0]}
    if kernel == "flash_attention":
        _, _, _, S, Sk, D = shape
        return {"variant": fa.variant(S, Sk, D, _torch_dtype(dtype))}
    if kernel == "paged_attention":
        B, Hq, Hkv, T, _ = shape
        bt = block_tokens(T)
        return {"bt": bt, "splits": pa.plan(B, Hkv, Hq // Hkv, T).splits}
    if kernel == "rmsnorm":
        return {"bwd_blocks": rms.bwd_blocks(shape[0])}
    if kernel == "reduction":
        return {"blocks": red.dot_blocks(red.dot_seg_len(shape[0]))}
    if kernel == "stencil":
        return {}
    raise ValueError(f"unknown kernel {kernel!r}")


def block_tokens(T: int, default: int = 16) -> int:
    """A pool block for ``T`` tokens a sequence: ``default`` (the serving
    launcher's 16 where no table names one) lowered to a power-of-two
    divisor of ``T``."""
    bt = max(1, min(default, T))
    while T % bt:
        bt //= 2
    return bt


def block_resources(kernel: str, shape, dtype: str, cfg: dict) -> dict:
    """What one block of the plan holds, as its kernel module states it
    (each beside its plan rule): shared memory in bytes (``static`` where
    it is a ``__shared__`` array), threads, and the blocks of the launch."""
    from . import flash_attention as fa
    from . import matmul as mm
    from . import paged_attention as pa
    from . import reduction as red
    from . import rmsnorm as rms
    from . import stencil as st

    if kernel == "matmul":
        M, K, N, trans = _mm_dims(shape)
        return mm.block_resources(mm.variant(M, K, N, _torch_dtype(dtype), trans=trans),
                                  M, K, N, trans, cfg["splits"])
    if kernel == "flash_attention":
        B, Hq, _, S, _, D = shape
        return fa.block_resources(cfg["variant"], B, Hq, S, D)
    if kernel == "paged_attention":
        B, Hq, Hkv, T, D = shape
        return pa.block_resources(B, Hkv, Hq // Hkv, T, D, _itemsize(dtype),
                                  cfg["splits"])
    if kernel == "rmsnorm":
        return rms.bwd_block_resources(*shape, _itemsize(dtype), cfg["bwd_blocks"])
    if kernel == "reduction":
        return red.dot_block_resources(cfg["blocks"])
    if kernel == "stencil":
        return st.jacobi_block_resources(*shape)
    raise ValueError(f"unknown kernel {kernel!r}")


def is_legal(kernel: str, shape, dtype: str, cfg: dict) -> bool:
    """The plan launches on the card: it has the family's knobs, its
    kernel module takes it (``matmul.legal_splits``,
    ``flash_attention.legal_variants``, ``paged_attention.legal_plan``,
    ``rmsnorm.legal_bwd_blocks``, ``reduction.legal_dot_blocks``), and its
    block fits ``hopper``'s limits."""
    from . import flash_attention as fa
    from . import matmul as mm
    from . import paged_attention as pa
    from . import reduction as red
    from . import rmsnorm as rms

    shape = tuple(int(s) for s in shape)
    if not isinstance(cfg, dict) or set(cfg) != set(DEFAULTS[kernel]):
        return False
    if kernel == "matmul":
        M, K, N, trans = _mm_dims(shape)
        ok = cfg["splits"] in mm.legal_splits(
            mm.variant(M, K, N, _torch_dtype(dtype), trans=trans), M, K, N, trans)
    elif kernel == "flash_attention":
        _, _, _, S, Sk, D = shape
        ok = cfg["variant"] in fa.legal_variants(S, Sk, D, _torch_dtype(dtype))
    elif kernel == "paged_attention":
        B, Hq, Hkv, T, _ = shape
        ok = pa.legal_plan(B, Hkv, Hq // Hkv, T, cfg["bt"], cfg["splits"])
    elif kernel == "rmsnorm":
        ok = rms.legal_bwd_blocks(shape[0], cfg["bwd_blocks"])
    elif kernel == "reduction":
        ok = red.legal_dot_blocks(cfg["blocks"])
    else:
        ok = kernel == "stencil"
    if not ok:
        return False
    r = block_resources(kernel, shape, dtype, cfg)
    return hopper.fits_block(r["smem"], r["threads"], static=r["static"])


def enumerate_candidates(kernel: str, shape, dtype: str = "float32") -> list[dict]:
    """The legal plans of one signature, the wrapper's own among them, in
    config order (the ranking orders them by cost)."""
    from . import paged_attention as pa

    shape = tuple(int(s) for s in shape)
    base = default_config(kernel, shape, dtype)
    if kernel == "matmul":
        from . import matmul as mm
        M, K, N, trans = _mm_dims(shape)
        kind = mm.variant(M, K, N, _torch_dtype(dtype), trans=trans)
        ns = mm.legal_splits(kind, M, K, N, trans)
        # the decode kernel's many counts: the ends, the powers of two and
        # the rule's own
        cands = [{"splits": n} for n in ns if kind != "decode" or n & (n - 1) == 0
                 or n in (ns[0], ns[-1], base["splits"])]
    elif kernel == "flash_attention":
        cands = [{"variant": "simt"}] + ([{"variant": "wgmma"}]
                                         if base["variant"] == "wgmma" else [])
    elif kernel == "paged_attention":
        B, Hq, Hkv, T, _ = shape
        bts = [bt for bt in (8, 16, 32, 64) if T % bt == 0] or [base["bt"]]
        splits = sorted({pa.plan_with_splits(B, Hkv, Hq // Hkv, T, n).splits
                         for n in (1, 2, 4, 8, 16)} | {base["splits"]})
        cands = [{"bt": bt, "splits": n} for bt in bts for n in splits]
    elif kernel == "rmsnorm":
        R = shape[0]
        cands = [{"bwd_blocks": p} for p in sorted(
            {min(R, p) for p in (hopper.SMS // 2, hopper.SMS, 2 * hopper.SMS,
                                 4 * hopper.SMS)} | {base["bwd_blocks"]}
            | {p for p in (1, 2) if p <= R})]
    elif kernel == "reduction":
        want = base["blocks"]
        cands = [{"blocks": b} for b in sorted(
            {min(want, b) for b in (hopper.SMS // 4, hopper.SMS // 2, hopper.SMS,
                                    2 * hopper.SMS, 4 * hopper.SMS)} | {want})
            if b >= 1]
    elif kernel == "stencil":
        cands = [{}]
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    cands = [c for c in cands if is_legal(kernel, shape, dtype, c)]
    if base not in cands and is_legal(kernel, shape, dtype, base):
        cands.append(base)
    return sorted(cands, key=lambda c: sorted(c.items()))


# ---------------------------------------------------------------- cost model

def model_cost(kernel: str, shape, dtype: str, cfg: dict) -> dict:
    """Price one plan on the H100: bytes each input read once and each
    output written once (partials of a split both ways), operations on the
    unit the plan runs on (the tensor cores' bf16 peak for ``decode``,
    ``wgmma``, a third of their TF32 peak for the ``tf32x3`` kernels; the
    CUDA cores' f32 for ``simt`` and the others), the core
    time the larger of the two over the share of the SMs the blocks fill,
    plus ``WAVE_US`` a wave and a split charge.  Returns the µs
    breakdown."""
    from . import matmul as mm
    from . import paged_attention as pa

    shape = tuple(int(s) for s in shape)
    isz = _itemsize(dtype)
    res = block_resources(kernel, shape, dtype, cfg)
    splits, split_us, peak = 1, SPLIT_US, hopper.PEAK_OPS_S["f32"]
    if kernel == "matmul":
        M, K, N, trans = _mm_dims(shape)
        kind = mm.variant(M, K, N, _torch_dtype(dtype), trans=trans)
        splits = cfg["splits"]
        flops = 2.0 * M * K * N
        nbytes = (M * K + K * N + M * N) * isz + (2 * splits * M * N * 4
                                                 if splits > 1 else 0)
        if kind != "simt":
            peak = hopper.PEAK_OPS_S["tf32x3" if kind == "tf32x3" else "bf16"]
        if kind == "wgmma":
            split_us = mm.WGMMA_SPLIT_US
    elif kernel == "flash_attention":
        B, Hq, Hkv, S, Sk, D = shape
        flops = 4.0 * B * Hq * S * Sk * D * (0.5 if S == Sk else 1.0)
        nbytes = (2 * B * Hq * S * D + 2 * B * Hkv * Sk * D) * isz
        peak = hopper.PEAK_OPS_S[{"wgmma": "bf16", "tf32x3": "tf32x3"}.get(cfg["variant"],
                                                                            "f32")]
    elif kernel == "paged_attention":
        B, Hq, Hkv, T, D = shape
        p = pa.plan_with_splits(B, Hkv, Hq // Hkv, T, cfg["splits"])
        splits = p.splits
        flops = 4.0 * B * Hq * T * D
        nbytes = (2 * B * Hkv * T * D * isz + 2 * B * Hq * D * isz
                  + B * (T // cfg["bt"]) * 4
                  + (2 * 4 * pa.workspace_floats(B, Hkv, D, p) if splits > 1 else 0))
    elif kernel == "rmsnorm":
        R, D = shape
        P = cfg["bwd_blocks"]
        flops = 10.0 * R * D
        nbytes = 5 * R * D * isz + 2 * D * 4 + 2 * P * D * 4
        splits = 2                      # the dgamma sum: a second grid
    elif kernel == "reduction":
        n = shape[0]
        flops, nbytes = 2.0 * n, 2 * n * isz + 4 * cfg["blocks"]
    elif kernel == "stencil":
        H, W = shape
        flops, nbytes = 5.0 * H * W, 2 * H * W * isz
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    share = min(1.0, res["blocks"] / hopper.SMS)
    core_us = max(nbytes / hopper.HBM_BYTES_S, flops / peak) / share * 1e6
    per_sm = max(1, hopper.blocks_per_sm(res["smem"], res["threads"]))
    waves = math.ceil(res["blocks"] / (hopper.SMS * per_sm))
    wave_us = WAVE_US * waves
    split_cost = split_us * (splits - 1)
    return {"core_us": core_us, "wave_us": wave_us, "split_us": split_cost,
            "bytes": nbytes, "flops": flops, "blocks": res["blocks"],
            "us": core_us + wave_us + split_cost}


def model_cost_us(kernel: str, shape, dtype: str, cfg: dict) -> float:
    return model_cost(kernel, shape, dtype, cfg)["us"]


def rank_candidates(kernel: str, shape, dtype: str, cands) -> list[tuple[dict, float]]:
    """Model-ranked (config, predicted µs), cheapest first; ties broken by
    config so the order is deterministic."""
    priced = [(c, model_cost_us(kernel, shape, dtype, c)) for c in cands]
    priced.sort(key=lambda cu: (cu[1], sorted(cu[0].items())))
    return priced


# ---------------------------------------------------------------- measurement

@contextlib.contextmanager
def _uncounted():
    """Launches inside are not counted (a candidate's check against its
    plain version, which ``kernels.launches`` must not add to a path)."""
    from .launches import LAUNCHES
    saved = dict(LAUNCHES)
    try:
        yield
    finally:
        LAUNCHES.update(saved)


def _case(kernel: str, shape, dtype: str, cfg: dict, device):
    """(fn, args, check) for one signature on ``device``: ``fn(*args)`` the
    wrapper's launch(es), ``check(out)`` the largest share of its limit the
    output uses against the plain version (``testing.kernel_checks``'
    tolerances and inputs)."""
    import torch

    from repro_torch.testing import kernel_checks as kc
    from . import flash_attention as fa
    from . import matmul as mm
    from . import paged_attention as pa
    from . import reduction as red
    from . import ref
    from . import rmsnorm as rms
    from . import stencil as st

    if kernel == "paged_attention":
        return _paged_case(shape, dtype, cfg["bt"], device)
    dt = _torch_dtype(dtype)
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=device) * scale).to(dt)

    if kernel == "matmul":
        M, K, N, trans = _mm_dims(shape)
        tol = kc.MATMUL_TOL[dt]
        if trans == 0:
            a, b = randn(M, K), randn(K, N, scale=K ** -0.5)
            return mm.matmul, (a, b), lambda c: kc.compare(c, ref.matmul(a, b), tol)
        if trans == 1:
            a, b = randn(M, K), randn(N, K, scale=K ** -0.5)
            return mm.grad_a, (a, b), \
                lambda c: kc.compare(c, ref.matmul_grad_a(a, b), tol)
        a, b = randn(K, M), randn(K, N, scale=K ** -0.5)
        return mm.grad_b, (a, b), lambda c: kc.compare(c, ref.matmul_grad_b(a, b), tol)
    if kernel == "flash_attention":
        B, Hq, Hkv, S, Sk, D = shape
        q = randn(B, S, Hq, D).transpose(1, 2)
        k, v = (randn(B, Sk, Hkv, D).transpose(1, 2) for _ in range(2))
        want = ref.attention(q, k, v, causal=True)
        return (lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=True)), \
            (q, k, v), lambda o: kc.compare(o, want, kc.ATTN_TOL[dt])
    if kernel == "rmsnorm":
        R, D = shape
        x, gamma, dy = kc.rmsnorm_bwd_inputs(R, D, dt, device)

        def run(x_, g_, dy_):
            return (rms.rmsnorm(x_, g_, kc.EPS),) + rms.backward(dy_, x_, g_, kc.EPS)
        want = (ref.rmsnorm(x, gamma, kc.EPS),) + ref.rmsnorm_bwd(dy, x, gamma, kc.EPS)
        tols = (kc.RMSNORM_TOL[dt], kc.RMSNORM_BWD_TOL["dx"][dt],
                kc.RMSNORM_BWD_TOL["dgamma"])
        return run, (x, gamma, dy), lambda outs: _worst(
            [kc.compare(o, w, t) for o, w, t in zip(outs, want, tols)])
    if kernel == "reduction":
        a, b = kc.vec_inputs(shape[0], dt, device)
        return red.dotprod, (a, b), lambda s: kc.compare_dot(
            s, s, a, b, red.dot_chain(red.dot_seg_len(a.numel()),
                                      bps=red.tuned_dot_blocks(a.numel(), a.dtype)))
    if kernel == "stencil":
        x = kc.grid_inputs(*shape, dt, device)
        return st.jacobi2d, (x,), lambda y: kc.compare(y, ref.jacobi2d(x), kc.JACOBI_TOL)
    raise ValueError(f"unknown kernel {kernel!r}")


def _paged_case(shape, dtype: str, bt: int, device):
    """Paged attention's case with the pool in blocks of ``bt`` tokens:
    disjoint full tables over a pool whose block 0 is the zero block, every
    sequence ``T`` long (the reference's ``_measure_case``)."""
    import torch

    from repro_torch.testing import kernel_checks as kc
    from . import paged_attention as pa
    from . import ref

    B, Hq, Hkv, T, D = shape
    dt = _torch_dtype(dtype)
    g = torch.Generator(device=device).manual_seed(0)
    nblk = T // bt
    q = torch.randn((B, Hkv, Hq // Hkv, D), generator=g, device=device).to(dt)
    pools = []
    for _ in range(2):
        p = torch.randn((B * nblk + 1, bt, Hkv, D), generator=g, device=device).to(dt)
        p[0] = 0
        pools.append(p.permute(2, 0, 1, 3))
    tables = torch.arange(1, B * nblk + 1, dtype=torch.int32, device=device).reshape(B, nblk)
    lens = torch.full((B,), T, dtype=torch.int32, device=device)
    args = (q, *pools, tables, lens)
    want = ref.paged_attention(*args)
    return pa.paged_attention, args, lambda o: kc.compare(o, want, kc.ATTN_TOL[dt])


def _worst(results: list) -> dict:
    out = max(results, key=lambda r: r["limit_use"])
    return {**out, "ok": all(r["ok"] for r in results)}


#: calls a timed sample holds (queued behind the spin kernel together)
INNER = 4
#: the bytes of operands a measurement rotates through: twice the L2, so
#: that each call reads its operands from HBM, as the main path reads a
#: layer's weights
ROTATE_BYTES = 2 * hopper.L2_BYTES


def rotation(args) -> int:
    """How many copies of ``args`` (itself and clones) together hold
    ``ROTATE_BYTES`` of tensors: one where a copy already does."""
    import torch
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    return max(1, math.ceil(ROTATE_BYTES / max(1, nbytes)))


def measure_candidate(kernel: str, shape, dtype: str, cfg: dict, *,
                      reps: int = 5, warmup: int = 1, topology_tag: str | None = None):
    """``(Sample, check)`` of one plan on the card: the wrapper run under a
    table that holds this plan alone, timed by ``timing.measure_us``
    (``INNER`` calls a sample, queued behind a spin kernel so that the
    events time the device; the calls rotate through :func:`rotation`'s
    copies of the operands, so that none reads them from L2; a sample whose
    IQR is over half its median is measured once more at double the reps),
    and its output held to the plain version (``check["limit_use"]``, the
    largest share of the limit; a plan over its limit raises)."""
    from repro_torch.testing import timing

    shape = tuple(int(s) for s in shape)
    one = TuneContext(topology_tag=topology_tag)
    one.table[signature(kernel, shape, dtype, one.topology_tag)] = {"winner": dict(cfg)}
    with tuned(one):
        fn, args, check = _case(kernel, shape, dtype, cfg, "cuda")
        copies = rotation(args)
        s = timing.measure_us(fn, *args, reps=reps, warmup=warmup, inner=INNER,
                              copies=copies)
        if s.reps >= 2 and s.iqr_us > 0.5 * s.median_us:
            s = timing.measure_us(fn, *args, reps=2 * reps, warmup=warmup,
                                  inner=INNER, copies=copies)
        with _uncounted():
            res = check(fn(*args))
    if not res["ok"]:
        raise AssertionError(f"autotune: {kernel} {shape} {dtype} plan {cfg} "
                             f"disagrees with its plain version: {res}")
    return s, res


# ---------------------------------------------------------------- context

def _card_name() -> str:
    import torch
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


class TuneContext:
    """Ambient tuning state: the winner table (read from ``cache_path``
    when it is first needed: a missing file is an empty table, a file that
    is not one raises; no path, no table until entries are added), the
    measurement policy, and ``hits``, the wrappers' reads that found a
    plan.  Installed with :func:`tuned`; the innermost context wins."""

    def __init__(self, cache_path=None, *, top_k: int = 3, reps: int = 5,
                 warmup: int = 1, topology_tag: str | None = None, measure=None):
        self.cache_path = pathlib.Path(cache_path) if cache_path else None
        self.top_k = top_k
        self.reps = reps
        self.warmup = warmup
        self._tag = topology_tag
        #: ``measure(kernel, shape, dtype, cfg) -> (Sample, check)``: the
        #: card's by default (:func:`measure_candidate`); the tests give
        #: their own
        self.measure = measure
        self._table = None
        self.hits = 0
        #: signature -> (its record, its winner) once :func:`is_legal` has
        #: passed them, so that a launch pays the check once a record
        self._legal: dict = {}

    @property
    def topology_tag(self) -> str:
        if self._tag is None:
            self._tag = _card_name()
        return self._tag

    @property
    def table(self) -> dict:
        if self._table is None:
            self._table = {} if self.cache_path is None else _read_table(self.cache_path)
        return self._table

    def save(self) -> None:
        if self.cache_path is None:
            return
        self.cache_path.parent.mkdir(parents=True, exist_ok=True)
        self.cache_path.write_text(json.dumps({"schema": 1, "entries": self.table},
                                              indent=1, sort_keys=True))

    def lookup(self, kernel: str, shape, dtype: str) -> dict | None:
        """The cached winner for a signature, or None."""
        rec = self.table.get(signature(kernel, shape, dtype, self.topology_tag))
        if isinstance(rec, dict) and isinstance(rec.get("winner"), dict):
            return dict(rec["winner"])
        return None


def _read_table(path: pathlib.Path) -> dict:
    """The entries of the table at ``path``: empty where there is no file
    yet (the autotuner starts one); a file that is not a table of the
    reference's format raises, so that no run takes untuned plans while
    its caller believes them tuned."""
    try:
        text = path.read_text()
    except FileNotFoundError:
        return {}
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise ValueError(f"autotune table {path}: not JSON ({e})") from None
    if not (isinstance(doc, dict) and doc.get("schema") == 1
            and isinstance(doc.get("entries"), dict)):
        raise ValueError(f"autotune table {path}: not a table of schema 1 "
                         f"({{'schema': 1, 'entries': {{...}}}})")
    return dict(doc["entries"])


class _Untuned(TuneContext):
    """The default context: no table, and none can be added (its ``table``
    is read-only), so that outside :func:`tuned` every plan is the
    wrapper's own rule."""

    @property
    def table(self):
        return types.MappingProxyType({})

    def save(self) -> None:
        raise RuntimeError("the default autotune context keeps no table")


#: the default context holds no table (see the module's note)
_STACK: list[TuneContext] = [_Untuned(topology_tag="none")]


def current() -> TuneContext:
    return _STACK[-1]


@contextlib.contextmanager
def tuned(cache_path=None, **kw):
    """Install a :class:`TuneContext` (or the one given) for the dynamic
    extent: every wrapper (and :func:`autotune`) inside resolves its plan
    against it."""
    ctx = cache_path if isinstance(cache_path, TuneContext) \
        else TuneContext(cache_path, **kw)
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


def tuned_config(kernel: str, shape, dtype) -> dict | None:
    """The wrappers' read: the ambient context's winner for this signature,
    or None (always None outside :func:`tuned`, without reading anything).
    A winner that is not a legal plan for the signature (:func:`is_legal`)
    raises."""
    if len(_STACK) == 1:
        return None
    ctx = _STACK[-1]
    dt = _dtype_name(dtype)
    sig = signature(kernel, shape, dt, ctx.topology_tag)
    rec = ctx.table.get(sig)
    if not (isinstance(rec, dict) and isinstance(rec.get("winner"), dict)):
        return None
    seen = ctx._legal.get(sig)
    if seen is None or seen[0] is not rec or seen[1] != rec["winner"]:
        if not is_legal(kernel, shape, dt, rec["winner"]):
            raise ValueError(f"autotune table: {kernel} {tuple(shape)} {dt}: "
                             f"{rec['winner']} is not a legal plan")
        seen = ctx._legal[sig] = (rec, dict(rec["winner"]))
    ctx.hits += 1
    return dict(seen[1])


# ---------------------------------------------------------------- autotune

def autotune(kernel: str, shape, dtype: str = "bfloat16", *, ctx=None,
             measure_all: bool = False) -> dict:
    """Enumerate -> model-rank -> measure the top-k -> cache.

    Returns (and saves) the record: every candidate with its model µs and
    rank, the shortlist's measured median and IQR and its check's share of
    the limit (``limit_use``), the winner, and whether the model's top-k
    held it (``agreement_at_k``).  A cached signature returns without
    measuring unless ``measure_all`` asks for every candidate.  It needs a
    context of its own: ``ctx``, or the innermost :func:`tuned` (the default
    context keeps no table)."""
    ctx = ctx or current()
    if isinstance(ctx, _Untuned):
        raise RuntimeError("autotune() outside tuned(): give it ctx=, or call it "
                           "inside `with tuned(path):`")
    shape = tuple(int(s) for s in shape)
    dtype = _dtype_name(dtype)
    sig = signature(kernel, shape, dtype, ctx.topology_tag)
    cached = ctx.table.get(sig)
    if cached is not None and not measure_all:
        return cached
    measure = ctx.measure or (lambda k, s, d, c: measure_candidate(
        k, s, d, c, reps=ctx.reps, warmup=ctx.warmup, topology_tag=ctx.topology_tag))

    ranked = rank_candidates(kernel, shape, dtype,
                             enumerate_candidates(kernel, shape, dtype))
    n_measure = len(ranked) if measure_all else min(ctx.top_k, len(ranked))
    entries = []
    for rank, (cfg, mus) in enumerate(ranked):
        e = {"config": cfg, "model_us": round(mus, 3), "model_rank": rank}
        if rank < n_measure:
            s, chk = measure(kernel, shape, dtype, cfg)
            e.update(measured_us=round(s.median_us, 3), iqr_us=round(s.iqr_us, 3),
                     reps=s.reps, limit_use=chk["limit_use"])
        entries.append(e)
    measured = sorted((e for e in entries if "measured_us" in e),
                      key=lambda e: (e["measured_us"], e["model_rank"]))
    for mrank, e in enumerate(measured):
        e["measured_rank"] = mrank
    win = measured[0]
    record = {
        "kernel": kernel,
        "shape": list(shape),
        "dtype": dtype,
        "topology": ctx.topology_tag,
        "top_k": ctx.top_k,
        "candidates": entries,
        "winner": dict(win["config"]),
        "model_rank_of_winner": win["model_rank"],
        "agreement_at_k": win["model_rank"] < ctx.top_k,
    }
    ctx.table[sig] = record
    ctx.save()
    return record


def fit_wgmma_costs(records) -> dict:
    """The step and split costs that measured split counts fit:
    ``t = c_shape + step_us * ceil(k_steps / n) + split_us * (n - 1)`` by
    least squares over every measured candidate of the wgmma matmul
    records given (one intercept a shape; each record's split counts within
    one wave, so a block's time is the kernel's).  Returns ``step_us``,
    ``split_us``, the samples and shapes used, and the residual's RMS."""
    import numpy as np

    from . import matmul as mm

    rows, ys, shapes = [], [], []
    for rec in records:
        M, K, N, trans = _mm_dims(rec["shape"])
        k_steps = math.ceil(K / mm.WGMMA_BK)
        pts = [(e["config"]["splits"], e["measured_us"]) for e in rec["candidates"]
               if "measured_us" in e]
        if len(pts) < 2:
            continue
        shapes.append(tuple(rec["shape"]))
        for n, t in pts:
            rows.append((len(shapes) - 1, math.ceil(k_steps / n), n - 1))
            ys.append(t)
    if len(ys) < len(shapes) + 2:
        return {"step_us": None, "split_us": None, "samples": len(ys),
                "shapes": shapes, "rms_us": None}
    A = np.zeros((len(ys), len(shapes) + 2))
    for i, (s, steps, extra) in enumerate(rows):
        A[i, s], A[i, -2], A[i, -1] = 1.0, steps, extra
    coef, *_ = np.linalg.lstsq(A, np.asarray(ys), rcond=None)
    resid = A @ coef - np.asarray(ys)
    return {"step_us": float(coef[-2]), "split_us": float(coef[-1]),
            "samples": len(ys), "shapes": shapes,
            "rms_us": float(np.sqrt(np.mean(resid ** 2)))}


# ---------------------------------------------------------------- CLI

#: the main path's shapes (bf16; the Table I kernels f32): llama3-8b's
#: projections at every main-path M (decode and prefill), the backward's
#: products at prefill-sized M (the 128 x 256 tile), two whole-prompt
#: prefills' attention, the batch-8 paged decode step, the decode step's
#: rmsnorm, and the Table I sizes
_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
CASES = {
    "matmul": [((M, K, N), "bfloat16") for M in (1, 4, 8, 128, 333, 512)
               for K, N in _KN]
    + [((M, K, N, 1), "bfloat16") for M in (128, 333, 512) for K, N in _KN],
    "flash_attention": [((1, 32, 8, S, S, 128), "bfloat16") for S in (223, 512)],
    "paged_attention": [((8, 32, 8, 1024, 128), "bfloat16")],
    "rmsnorm": [((4, 4096), "bfloat16")],
    "reduction": [((4096,), "float32"), ((2 ** 28,), "float32")],
    "stencil": [((256, 4096), "float32"), ((16384, 16384), "float32")],
}
SMOKE_CASES = {
    "matmul": [((4, 256, 512), "bfloat16"), ((128, 2048, 256), "bfloat16")],
    "flash_attention": [((1, 4, 2, 128, 128, 64), "bfloat16")],
    "paged_attention": [((2, 8, 2, 256, 64), "bfloat16")],
    "rmsnorm": [((16, 1024), "bfloat16")],
    "reduction": [((65536,), "float32")],
    "stencil": [((64, 256), "float32")],
}
#: where the CLI keeps its table by default, in the checkout
DEFAULT_CACHE = pathlib.Path(__file__).resolve().parents[3] / "build" / "autotune" / "cache.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.kernels.autotune",
        description="model-rank -> measure the shortlist on the card -> cache "
                    "the kernels' launch plans")
    ap.add_argument("--kernel", action="append", choices=KERNELS,
                    help="kernel family (repeatable; default: all)")
    ap.add_argument("--smoke", action="store_true", help="small shapes")
    ap.add_argument("--top-k", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--cache", type=pathlib.Path, default=DEFAULT_CACHE,
                    help="winner-table path (default build/autotune/cache.json)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("autotune: no CUDA card: the plans are the card's kernels' (on "
              "the CPU the plain versions take none)", flush=True)
        return 2
    cases = SMOKE_CASES if args.smoke else CASES
    with tuned(args.cache, top_k=args.top_k, reps=args.reps,
               warmup=args.warmup) as ctx:
        for kernel in args.kernel or list(KERNELS):
            for shape, dtype in cases[kernel]:
                rec = autotune(kernel, shape, dtype, ctx=ctx)
                win = next(e for e in rec["candidates"]
                           if e["config"] == rec["winner"] and "measured_us" in e)
                print(f"autotune/{signature(kernel, shape, dtype, ctx.topology_tag)},"
                      f"{win['measured_us']:.1f},winner={rec['winner']} "
                      f"model_rank={rec['model_rank_of_winner']} "
                      f"agree@{rec['top_k']}={rec['agreement_at_k']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
