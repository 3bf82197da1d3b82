"""Chained-unit pipeline model replaying ISA traces (the paper's §IV rig).

The model captures the mechanisms the paper's evaluation turns on:

* every vector instruction streams ``ceil(vl/n) * cycles_per_elem`` cycles
  through its unit (one element per lane per cycle);
* units chain: a consumer starts ``chain_lat`` cycles behind its producer
  (program-order proxy for the dependence graph);
* the CVA6 front end issues one vector instruction per ``issue_gap +
  reqi_lat`` cycles (REQI ack round trip), with a bounded in-flight window,
  and pays d-cache latency for interleaved scalar operands;
* vector loads see the GLSU request-response latency (``glsu_lat``) before
  the first element lands;
* slides pay ``params.slide_cost(hops)`` before streaming — priced per wire
  level by the shared :class:`repro_torch.topology.Topology` (each link at the
  outermost boundary it crosses: intra-cluster short wires, the inter-
  cluster RINGI ring, and the pod ring beyond it for ``n_pods > 1``; every
  hop at the longest-wire price under ``"flat"``); traces tag each slide
  with the wire level its critical path crosses;
* reductions stream their intra-lane phase on the FPU, then pay the
  vl-independent log-tree latency of every topology level
  (``params.red_tree_lat()``, hierarchy-dependent) — the exact term the
  paper blames for the softmax / fdotproduct scaling gap;
* FPU utilization = FPU-busy cycles / total cycles, the paper's metric.

Overlap model (``overlap=``)
----------------------------

Wire latencies (slide hops, reduction log-trees) can ride the interconnect
while the FPUs stream — AraXL's headline claim.  ``simulate`` accounts for
this in both modes:

* every wire wait is split into **hidden** cycles (spent behind issue /
  unit occupancy or backfilled work, costing nothing extra) and
  **exposed** cycles (wire latency that actually delays the dependent
  instruction), tallied per wire-class label in
  :attr:`SimResult.wire_exposed` / :attr:`SimResult.wire_hidden` (slides
  under their topology level, reduction trees under ``"tree"``);

* ``overlap=False`` (default, the paper-calibrated machine) keeps every
  unit strictly in program order, so a wire wait leaves a bubble later
  instructions cannot fill — the calibration is bit-identical to the
  historical engine;

* ``overlap=True`` models the double-buffered schedules (this repo's
  beyond-paper machine): a wire wait opens a *gap* on the stalled unit and
  later, independent instructions may backfill it — a slide / tree issued
  at least its latency before the dependent op costs nothing, otherwise
  only the exposed remainder is paid.  True register dependencies are
  never violated; only unit head-of-line blocking is relaxed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.isa import InstrRecord
from .params import AraXLParams

#: extra cycles per element-group beyond 1 (vexp: 28 FLOP over 21 cycles/elem)
CYCLES_PER_ELEM = {"vexp(poly)": 21.0}

#: which units' streaming counts as "FPU producing valid results"
FPU_UNITS = {"fpu", "redu"}

#: wire-class label for reduction log-tree latency in the exposed/hidden tally
TREE_LABEL = "tree"


@dataclasses.dataclass
class SimResult:
    cycles: float
    fpu_busy: float
    flops: float
    n_instrs: int
    unit_busy: dict
    #: wire cycles that delayed a dependent instruction, by wire class
    #: (slide topology levels + "tree" for reduction log-trees)
    wire_exposed: dict = dataclasses.field(default_factory=dict)
    #: wire cycles hidden behind issue / occupancy / backfilled work
    wire_hidden: dict = dataclasses.field(default_factory=dict)

    @property
    def utilization(self) -> float:
        return self.fpu_busy / self.cycles if self.cycles else 0.0

    @property
    def flop_per_cycle(self) -> float:
        return self.flops / self.cycles if self.cycles else 0.0

    def gflops(self, freq_ghz: float) -> float:
        return self.flop_per_cycle * freq_ghz

    @property
    def wire_exposed_total(self) -> float:
        return sum(self.wire_exposed.values())

    @property
    def wire_hidden_total(self) -> float:
        return sum(self.wire_hidden.values())


class _GapUnit:
    """One execution unit with backfillable idle gaps (overlap mode).

    ``place(earliest, dur)`` returns the start of the first window of
    ``dur`` cycles at or after ``earliest`` — either inside a previously
    opened gap or at the end of the unit's schedule; ``commit`` books it.
    The sequential engine is the degenerate case where gaps are never
    reused (every op starts at ``max(earliest, end)``).
    """

    __slots__ = ("end", "gaps")

    def __init__(self):
        self.end = 0.0
        self.gaps: list[tuple[float, float]] = []

    def place(self, earliest: float, dur: float) -> float:
        for g0, g1 in self.gaps:
            s = max(g0, earliest)
            if s + dur <= g1:
                return s
        return max(self.end, earliest)

    def commit(self, start: float, dur: float) -> None:
        for i, (g0, g1) in enumerate(self.gaps):
            if g0 <= start and start + dur <= g1:
                repl = []
                if start > g0:
                    repl.append((g0, start))
                if start + dur < g1:
                    repl.append((start + dur, g1))
                self.gaps[i:i + 1] = repl
                return
        if start > self.end:
            self.gaps.append((self.end, start))
        self.end = start + dur


def simulate(trace: Sequence[InstrRecord], params: AraXLParams, *,
             overlap: bool = False) -> SimResult:
    """Replay ``trace`` through the pipeline model.

    ``overlap=False`` is the paper-calibrated sequential-unit machine
    (bit-identical to the historical engine).  ``overlap=True`` lets
    independent instructions backfill wire-wait bubbles (the double-
    buffered schedules); both modes tally exposed vs hidden wire cycles.
    """
    n = params.n_lanes
    issue_t = 0.0                  # sequencer clock
    pending_scalar = 0.0           # scalar-side cost accrued since last vector op
    unit_free: dict[str, float] = {}           # sequential mode
    units: dict[str, _GapUnit] = {}            # overlap mode
    ready: dict[int, float] = {}   # reg id -> chain-from time (true RAW deps)
    #: reg id -> (wire cycles riding behind the value, wire-class label):
    #: the part of ``ready`` a double-buffered consumer could still hide
    wire_tail: dict[int, tuple[float, str]] = {}
    starts: list[float] = []       # start times (for the in-flight window)
    fpu_busy = 0.0
    flops = 0.0
    unit_busy: dict[str, float] = {}
    wire_exposed: dict[str, float] = {}
    wire_hidden: dict[str, float] = {}
    end = 0.0
    n_vec = 0
    max_finish = 0.0               # latest streaming finish (no wire tails)
    tree_tails: list[tuple[float, float, int]] = []  # (complete, tree, out id)
    consumed: set[int] = set()     # reg ids some later instruction depends on

    def avail(unit: str, earliest: float, dur: float) -> float:
        if overlap:
            return units.setdefault(unit, _GapUnit()).place(earliest, dur)
        return max(unit_free.get(unit, 0.0), earliest)

    def book(unit: str, start: float, dur: float) -> None:
        if overlap:
            units[unit].commit(start, dur)
        else:
            unit_free[unit] = start + dur

    def tally(label: str, wire: float, exposed: float) -> None:
        exposed = min(max(exposed, 0.0), wire)
        if exposed:
            wire_exposed[label] = wire_exposed.get(label, 0.0) + exposed
        hidden = wire - exposed
        if hidden:
            wire_hidden[label] = wire_hidden.get(label, 0.0) + hidden

    for rec in trace:
        if rec.unit == "scalar":
            pending_scalar += (params.dcache_lat if rec.op == "ld"
                               else params.scalar_op_gap) * rec.vl
            continue
        if rec.unit == "seq":      # vsetvli etc: pure issue-side cost
            pending_scalar += params.scalar_op_gap
            continue

        n_vec += 1
        cpe = CYCLES_PER_ELEM.get(rec.op, 1.0)
        dur = math.ceil(rec.vl / n) * cpe
        meta = rec.meta or {}

        # ---- front end -----------------------------------------------------
        issue_t = issue_t + params.issue_gap + params.reqi_lat + pending_scalar
        pending_scalar = 0.0
        if len(starts) >= params.inflight:
            issue_t = max(issue_t, starts[-params.inflight])

        # ---- unit occupancy + true-dependency chaining -----------------------
        # Loads and stores take the VLSU's independent AXI R / W paths.
        if rec.op.startswith("vle"):
            unit = "vldu"
        elif rec.op.startswith("vse"):
            unit = "vstu"
        elif rec.unit == "redu":
            unit = "fpu"
        else:
            unit = rec.unit
        deps = meta.get("deps", ())
        consumed.update(deps)
        dep_t = max((ready.get(d, 0.0) for d in deps), default=0.0)
        # the wire tail still riding behind the binding dependency (a
        # reduction's log-tree, an upstream slide's hop): the overlap
        # machine could hide it, the sequential machine exposes whatever
        # is not already behind issue / unit occupancy
        dep_wire, dep_label, dep_rid = 0.0, None, None
        for d in deps:
            if d in wire_tail and ready.get(d, 0.0) == dep_t:
                dep_wire, dep_label = wire_tail[d]
                dep_rid = d
        if rec.op.startswith("vle"):
            # GLSU requests pipeline: the request->first-beat latency is only
            # exposed when the load path was idle (back-to-back bursts hide it
            # behind the previous transfer) — this is the latency *tolerance*
            # mechanism of Fig. 7(a).
            earliest_wire = max(issue_t + params.glsu_lat, dep_t)
            earliest_base = earliest_wire
            hop, hop_label = 0.0, None
        elif rec.unit == "sldu":
            hop = params.slide_cost(max(1, meta.get("hops", 1)))
            hop_label = meta.get("level", "inter")
            earliest_wire = max(issue_t, dep_t + hop)
            earliest_base = max(issue_t, dep_t)
        else:
            earliest_wire = max(issue_t, dep_t)
            earliest_base = max(issue_t, dep_t - dep_wire)
            hop, hop_label = 0.0, None

        start = avail(unit, earliest_wire, dur)
        if hop_label is not None and hop:
            # slide: its own hop is exposed insofar as the slide starts
            # later than it would on a zero-latency wire
            tally(hop_label, hop, start - avail(unit, earliest_base, dur))
        elif dep_label is not None and dep_wire:
            # consumer of a wire-carried value (a reduction tree): exposed =
            # the delay the tail actually causes here; charged once — later
            # consumers of the same value see an already-paid wire
            tally(dep_label, dep_wire,
                  start - avail(unit, earliest_base, dur))
            del wire_tail[dep_rid]
        book(unit, start, dur)
        unit_busy[unit] = unit_busy.get(unit, 0.0) + dur

        finish = start + dur
        max_finish = max(max_finish, finish)
        if rec.unit == "redu":
            tree = params.red_tree_lat()
            complete = finish + tree
            res_ready = complete                       # scalar result: no chaining
            if "out" in meta:
                wire_tail[meta["out"]] = (tree, TREE_LABEL)
                tree_tails.append((complete, tree, meta["out"]))
        else:
            # slides charge their hop at their own start (above), so the
            # value they produce carries no further wire tail downstream
            complete = finish
            res_ready = start + params.chain_lat       # stream-chainable
        if "out" in meta:
            ready[meta["out"]] = res_ready

        if rec.unit in FPU_UNITS:
            fpu_busy += dur
        flops += rec.flops_per_elem * rec.vl
        end = max(end, complete)
        starts.append(start)

    # Reduction trees never consumed by a tracked vector instruction (their
    # scalar lands in the core) still gate completion: whatever part of the
    # latest such tree sticks out past every streaming finish is exposed;
    # the rest — and every earlier unconsumed tree — rode the wires behind
    # ongoing work and is hidden.
    loose = sorted((c, t) for c, t, rid in tree_tails if rid not in consumed)
    for i, (complete, tree) in enumerate(loose):
        below = max(max_finish, loose[i - 1][0] if i else 0.0)
        tally(TREE_LABEL, tree,
              complete - below if complete == loose[-1][0] else 0.0)

    return SimResult(cycles=end, fpu_busy=fpu_busy, flops=flops,
                     n_instrs=n_vec, unit_busy=unit_busy,
                     wire_exposed=wire_exposed, wire_hidden=wire_hidden)
