"""Three-term roofline of a cell on the H100 (the arithmetic of the
reference's ``repro.roofline.analysis``, copied: this package imports none
of it).

    compute    = FLOPs a device / bf16 dense peak
    memory     = bytes a device / HBM rate
    collective = per-level wire seconds (below); flat fallback
                 wire_bytes / the card's link rate

The reference parses its collectives out of compiled HLO text
(``parse_collectives``); the port has no HLO.  Its collectives are the ones
``parallel.comm`` records as a rank runs them (``Mesh.records``: kind,
result bytes, group size, the group's ranks as ``members`` and a shift's
``pairs``), in the record shape :func:`collective_level_bytes` reads, with
the wire factors of a ring schedule:

    all-gather      (n-1)/n x result_bytes      received per device
    reduce-scatter  (n-1)/n x result_bytes
    all-reduce      2(n-1)/n x result_bytes     (RS + AG)
    all-to-all      (n-1)/n x result_bytes
    collective-perm result_bytes                (one neighbour hop)

Per-level pricing: a group's ranks are mesh-flat (outer-major) positions,
exactly the flattened ring positions ``Topology.coords`` decodes, so the
group maps onto the levels it crosses (:func:`group_level_extents`); a
ring run hierarchically carries ``wire_factor(e_i) / O_i`` of the payload
on level *i*'s wires (``O_i`` the outer extents' product), which
telescopes to the flat total.  Each level's bytes are priced at the
topology's ``wire_bw`` (the reference's launch-layer prices); the flat
model prices everything at the outermost class and equals
:func:`wire_seconds` for a single-level topology whose wire rate is the
``hw`` link rate.

``HW`` holds the H100's rates; every function that reads a rate takes
``hw=`` (the tests pass the reference's constants to hold the arithmetic
to it).  The port runs every period eagerly, so its dry run needs no
1-/2-period extrapolation; :func:`extrapolate` stays as the roofline's
function.
"""
from __future__ import annotations

import math

from repro_torch.kernels import hopper
from repro_torch.topology import Topology

#: the NVIDIA H100 SXM5 80GB's rates: bf16 dense tensor-core peak, HBM3,
#: and NVLink 4 in one direction (the link a collective's ring rides)
HW = {
    "card": hopper.CARD,
    "peak_flops": hopper.PEAK_OPS_S["bf16"],
    "hbm_bw": hopper.HBM_BYTES_S,
    "ici_bw": hopper.NVLINK_BYTES_S,
}

_WIRE_FACTOR = {
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: (n - 1) / max(n, 1),
    "all-reduce": lambda n: 2 * (n - 1) / max(n, 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}


def collective_bytes(colls: list[dict]) -> dict:
    """Aggregate wire bytes per device, by kind and total."""
    by_kind: dict[str, float] = {}
    total = 0.0
    for c in colls:
        wire = c["bytes"] * _WIRE_FACTOR[c["kind"]](max(1, c["group"]))
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0.0) + wire
        total += wire
    by_kind["total"] = total
    by_kind["count"] = len(colls)
    return by_kind


def wire_seconds(wire_bytes: float, hw: dict | None = None) -> float:
    """Flat pricing: every byte rides the single-class link."""
    return wire_bytes / (hw or HW)["ici_bw"]


# ---------------------------------------------------------------------------
# group -> topology-level mapping (per-level pricing)
# ---------------------------------------------------------------------------

def group_level_extents(members, topology: Topology) -> tuple[int, ...]:
    """Per-level extents (distinct level coordinates) one group spans,
    outermost first.

    A group's ranks are mesh-flat outer-major positions, i.e. exactly the
    flattened ring positions :meth:`Topology.coords` decodes (the production
    mesh has one dimension per level).  A mesh-axis-aligned group is a subgrid,
    so ``prod(extents) == len(members)``; a group that is not axis-aligned
    (or references devices outside the topology) falls back to a flat ring
    over the whole group at the outermost spanned level — the conservative
    long-wire attribution.
    """
    n = topology.n_lanes
    if not members or max(members) >= n:
        return (len(members or ()),) + (1,) * (topology.n_levels - 1)
    coords = [topology.coords(m) for m in members]
    extents = tuple(len({c[i] for c in coords})
                    for i in range(topology.n_levels))
    if math.prod(extents) != len(members):
        # degenerate duplicates (all extents 1) land on the outermost level
        outermost = next((i for i, e in enumerate(extents) if e > 1), 0)
        extents = tuple(len(members) if i == outermost else 1
                        for i in range(topology.n_levels))
    return extents


def _ring_level_factors(kind: str, extents) -> list[float]:
    """Per-level wire factors (fraction of payload bytes on each level's
    wires, outermost first) of the hierarchical ring schedule.

    Level i moves ``wire_factor(e_i) / O_i`` of the payload, where ``O_i``
    is the product of the *outer* extents: the outer rings exchange whole
    superchunks ((e-1)/e of the payload), each inner ring only its level's
    1/O_i-sized slice.  Telescopes to the flat ``(n-1)/n`` (2(n-1)/n for
    all-reduce), so total wire bytes are conserved — only their class moves.
    """
    f = _WIRE_FACTOR[kind]
    out, outer = [], 1
    for e in extents:
        out.append(f(max(1, e)) / outer if e > 1 else 0.0)
        outer *= max(1, e)
    return out


def _permute_level_factors(pairs, topology: Topology) -> list[float]:
    """Per-level factors for collective-permute: the fraction of pairs whose
    source→target path crosses each level (outermost differing coordinate).
    The factors always sum to exactly 1.0 — matching the flat _WIRE_FACTOR
    convention that a permute charges the full operand once per op — so
    per-level attribution only reclassifies those bytes, never rescales
    them."""
    counts = [0] * topology.n_levels
    n = topology.n_lanes
    if not pairs:
        # no pair structure parsed: a neighbour hop rides the innermost ring
        out = [0.0] * topology.n_levels
        out[-1] = 1.0
        return out
    for s, d in pairs:
        if max(s, d) >= n:
            # pair references devices outside this topology (mesh mismatch):
            # charge the outermost (long) wires, like group_level_extents
            counts[0] += 1
            continue
        cs, cd = topology.coords(s), topology.coords(d)
        lvl = next((i for i in range(topology.n_levels) if cs[i] != cd[i]),
                   topology.n_levels - 1)
        counts[lvl] += 1
    return [c / len(pairs) for c in counts]


def collective_level_bytes(colls: list[dict], topology: Topology) -> dict:
    """Aggregate per-device wire bytes by topology wire-class label
    (:meth:`Topology.wire_labels`, outermost first), plus ``total``.

    Under ``hierarchy="flat"`` every byte is attributed to the outermost
    label — the flattened-ring model the paper argues against.
    """
    labels = topology.wire_labels()
    by_level = {lab: 0.0 for lab in labels}
    total = 0.0
    for c in colls:
        kind = c["kind"]
        if topology.hierarchy == "flat":
            wire = c["bytes"] * _WIRE_FACTOR[kind](max(1, c["group"]))
            by_level[labels[0]] += wire
            total += wire
            continue
        if kind == "collective-permute":
            factors = _permute_level_factors(c.get("pairs"), topology)
        elif "members" in c:
            ext = group_level_extents(c["members"], topology)
            factors = _ring_level_factors(kind, ext)
        else:
            # size-only parse: attribute to the outermost (long) wires
            factors = [0.0] * topology.n_levels
            factors[0] = _WIRE_FACTOR[kind](max(1, c["group"]))
        for lab, f in zip(labels, factors):
            by_level[lab] += c["bytes"] * f
            total += c["bytes"] * f
    by_level["total"] = total
    return by_level


def level_wire_seconds(level_bytes: dict, topology: Topology) -> dict:
    """Price per-level wire bytes (a :func:`collective_level_bytes` dict) by
    each level's ``wire_bw``: {label: seconds, "total": sum}.  The flat
    hierarchy prices its (all-outermost) bytes at the outermost wire class;
    for a single-level topology that is the historical
    ``wire_seconds()`` bit-identically (innermost default bw == ici_bw)."""
    labels = topology.wire_labels()
    out = {}
    for lab in labels:
        out[lab] = level_bytes.get(lab, 0.0) / topology.wire_bw(lab)
    out["total"] = sum(out[lab] for lab in labels)
    return out


def exposed_level_seconds(level_secs: dict, compute_s: float,
                          topology: Topology) -> dict:
    """Overlap-aware exposure: how much of each level's collective seconds
    cannot hide behind the step's compute.

    The additive roofline assumes communicate-then-compute; the double-
    buffered schedules (ring attention ``schedule="db"``, the bucketed
    gradient sync) let a collective ride the wires while the FPUs stream.
    An ideally-overlapped schedule therefore only *exposes*

        exposed_i = max(0, collective_s_i - overlappable compute)

    where the compute budget is claimed innermost level first — the short
    intra-ring hops interleave tightest with the consuming compute (one
    hop per microbatch / block), while the outermost (pod) ring only has
    whatever compute the inner levels left unclaimed to hide behind.
    Always ``exposed_i <= collective_s_i`` per level; with zero compute it
    degenerates to the additive pricing.  Returns {label: seconds,
    "total": sum}.
    """
    labels = topology.wire_labels()
    budget = max(0.0, compute_s)
    out = {}
    for lab in reversed(labels):                      # innermost first
        c = level_secs.get(lab, 0.0)
        out[lab] = max(0.0, c - budget)
        budget = max(0.0, budget - c)
    out = {lab: out[lab] for lab in labels}           # outermost-first order
    out["total"] = sum(out[lab] for lab in labels)
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float,
                   collective_s: float | None = None,
                   hw: dict | None = None) -> dict:
    """Three-term roofline.  ``collective_s`` overrides the flat wire price
    (the dry run passes the per-level total from
    :func:`level_wire_seconds`); default is the flat pricing."""
    hw = hw or HW
    compute = flops_per_dev / hw["peak_flops"]
    memory = bytes_per_dev / hw["hbm_bw"]
    coll = (wire_seconds(wire_bytes_per_dev, hw) if collective_s is None
            else collective_s)
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": coll}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]
                              if k.endswith("_s") else -1)
    terms["step_s_lower_bound"] = max(compute, memory, coll)
    return terms


def extrapolate(f1: float, f2: float, n_periods: int) -> float:
    """total(L) from 1- and 2-period compiles (scan body counted once)."""
    return f1 + (n_periods - 1) * (f2 - f1)


def mesh_factors(n_dev: int, topology: Topology | None = None
                 ) -> tuple[int, int]:
    """(dp, msize): data-parallel ways and TP (model) ways of one cell.

    Derived from the topology when given — the innermost level is the TP
    lane group, everything outer is data-parallel — falling back to the
    historical ``n_dev // 16`` production heuristic (a 16-wide `model`
    axis) when the cell's geometry is unknown.
    """
    if topology is not None:
        msize = topology.lanes_per_cluster
        dp = max(1, n_dev // msize)
    else:
        msize = min(16, n_dev)
        dp = max(1, n_dev // 16)
    return dp, msize


def resident_model_bytes(cfg, shape, n_dev: int, nm: int,
                         args_bytes: float,
                         topology: Topology | None = None) -> float:
    """Analytic per-device memory *residency*, the reference's formula:
    the state updated in place, one gradient buffer.  Residency =

        args (exact: the dry run's state and inputs)
      + grads (one param-sized buffer, acc dtype)
      + grad accumulator (if microbatched)
      + layer-boundary activation saves (seq-sharded residual x L)
      + transient workspace (attention chunk + MoE dispatch + CE chunk),
        bounded by the largest single layer's working set x2.
    """
    bpe = 2
    P = cfg.n_params()
    dp, msize = mesh_factors(n_dev, topology)
    grads = P * bpe / n_dev
    acc = grads if (shape.kind == "train" and nm > 1) else 0.0
    if shape.kind != "train":
        return args_bytes + 2**30            # caches are args; +1GiB workspace
    B_mb_loc = max(1, shape.global_batch // nm // dp)
    x_save = cfg.n_layers * B_mb_loc * shape.seq_len * cfg.d_model * bpe \
        / msize                              # act_seq-sharded residual saves
    # largest layer working set (recompute live set), x2 safety
    ffe = cfg.d_ff_expert or cfg.d_ff or cfg.d_inner_ssm
    work = 2 * (B_mb_loc * shape.seq_len
                * max(cfg.d_model, ffe // msize * 4) * 4)
    ce = 2 * B_mb_loc * max(1, cfg.loss_chunk or 512) \
        * cfg.vocab_size // msize * 4
    return args_bytes + grads + acc + x_save + work + ce


def memory_model_bytes(cfg, shape, n_dev: int, nm: int,
                       topology: Topology | None = None) -> float:
    """Analytic per-device HBM traffic, the reference's formula (a second
    opinion beside the dry run's count of every op's operands, which no
    fusion reduces): only the traffic a fused program must pay:

      weights   3x local bf16 params per microbatch (fwd + bwd + remat re-read)
      optimizer 16 B/param local (m, v, master read+write, grad, param)
      acts      c_act x tokens_loc x d x 2 B per layer (c_act ~= 12:
                residual save+load, qkv/mlp intermediates, f32 upcasts)
      scores    2 x B_loc x H_loc x S x T x 4 B per attention layer (chunked)
      caches    decode: full KV/state cache read per step
    """
    bpe = 2
    P_loc = cfg.n_params() * bpe / n_dev
    d = cfg.d_model
    dp, msize = mesh_factors(n_dev, topology)
    if shape.kind == "train":
        B_loc_mb = max(1, shape.global_batch // nm // dp)
        toks = B_loc_mb * shape.seq_len
        c_act = 12.0
        act = nm * cfg.n_layers * c_act * toks * d * bpe
        n_attn = sum(1 for layer in cfg.layer_period
                     for k in layer if k in ("attn", "xattn")) * cfg.n_periods
        H_loc = max(1, cfg.n_heads // msize)
        scores = nm * n_attn * 2 * B_loc_mb * H_loc * shape.seq_len \
            * shape.seq_len * 4
        weights = nm * 3 * P_loc
        opt = 16 * cfg.n_params() / n_dev
        return act + scores + weights + opt
    if shape.kind == "prefill":
        B_loc = max(1, shape.global_batch // dp)
        toks = B_loc * shape.seq_len
        act = cfg.n_layers * 6.0 * toks * d * bpe
        H_loc = max(1, cfg.n_heads // msize)
        n_attn = sum(1 for layer in cfg.layer_period
                     for k in layer if k in ("attn", "xattn")) * cfg.n_periods
        scores = n_attn * B_loc * H_loc * shape.seq_len * shape.seq_len * 4
        return act + P_loc + scores
    # decode: weights + cache residency read once per token
    W = min(shape.seq_len, cfg.window) if cfg.window else shape.seq_len
    n_attn = sum(1 for layer in cfg.layer_period
                 for k in layer if k == "attn") * cfg.n_periods
    cache = n_attn * 2 * shape.global_batch * W * cfg.n_kv_heads \
        * cfg.head_dim * bpe / n_dev
    return P_loc + cache
