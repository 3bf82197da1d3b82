"""Microarchitectural parameters of the simulated machines.

Structural numbers (lanes/cluster, reduction stages, interface registers) come
straight from the paper; a handful of latency constants are calibrated once so
the model hits the paper's reported operating points (Fig. 6/7) and then kept
frozen (the reference's paper-validation tests assert the bands, and
``tests/test_torch_sim.py`` holds this copy to them).

Machine *geometry* lives in :class:`repro_torch.topology.Topology` — the same type
the emulation layer (`repro_torch.core.machine.make_machine`) and the launch layer
consume.  ``AraXLParams`` composes one (``params.topology``) from its lane
grid and interface latencies, and every geometry-dependent price
(``red_tree_lat``, ``slide_cost``, per-level ``hop_cost``) routes through it,
so the analytical model and the JAX emulator always price the same
interconnect.

The topology is an ordered list of levels.  With the default ``n_pods=1`` it
is the paper's two-level (cluster, lane) machine and ``hierarchy`` selects
between the §III-B.4 design (``"two-level"``, the calibrated default: intra-
cluster and inter-cluster wires priced separately) and the flattened ring the
paper argues against (``"flat"``: every hop a long-wire RINGI hop).  Setting
``n_pods > 1`` grows a third, outermost (pod, cluster, lane) level priced at
``pod_hop`` cycles/hop — the beyond-paper multi-pod scaling surface; all
pricing methods dispatch over the level list, so deeper hierarchies need no
new code here.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.topology import Level, Topology, check_hierarchy, hier_name


@dataclasses.dataclass(frozen=True)
class AraXLParams:
    name: str = "araxl"
    n_lanes: int = 64                 # total FPUs (= lanes; 1 DP-FPU per lane)
    lanes_per_cluster: int = 4        # the max-efficiency Ara2 building block
    n_pods: int = 1                   # >1 adds an outermost (pod) ring level
    hierarchy: str = "two-level"      # §III-B.4 interconnect (vs "flat" ring)
    vlen_bits: int = 65536            # 64 Kibit/vreg (RVV 1.0 maximum)
    sew_bits: int = 64                # DP evaluation, as in the paper
    freq_ghz: float = 1.15            # 64L typical corner (1.4 up to 32L)

    # --- scalar / dispatch side ------------------------------------------
    issue_gap: float = 3.5            # CVA6 -> sequencer accept, cycles/instr
    reqi_regs: int = 0                # Fig 7(b): +1 reg => ack +2 cycles
    scalar_op_gap: float = 1.0        # bookkeeping scalar ops between vector instrs
    dcache_lat: float = 6.0           # scalar load (e.g. A[i,k]) through d-cache
    inflight: int = 8                 # dispatch window (outstanding vector instrs)

    # --- vector units ------------------------------------------------------
    chain_lat: float = 6.0            # producer->consumer chaining delay
    fpu_lat: float = 5.0              # FPU pipeline depth (drain per instr)
    vlsu_setup: float = 14.0          # AXI request + L2 access latency
    glsu_regs: int = 0                # Fig 7(a): +4 regs => +8 cycles req-resp
    ringi_regs: int = 0               # Fig 7(c): +1 reg => +1 cycle/hop
    ring_hop: float = 4.0             # base inter-cluster hop latency
    intra_hop: float = 2.0            # short-wire intra-cluster sldu hop
    pod_hop: float = 8.0              # inter-pod ring hop (n_pods > 1 only)
    interlane_lat: float = 6.0        # intra-cluster A2A stage latency
    simd_red_cycles: float = 4.0      # final SIMD reduction stage

    def __post_init__(self):
        if self.n_lanes < 1 or self.lanes_per_cluster < 1 or self.n_pods < 1:
            raise ValueError(f"need n_lanes/lanes_per_cluster/n_pods >= 1, "
                             f"got {self.n_lanes}/{self.lanes_per_cluster}/"
                             f"{self.n_pods}")
        if self.n_lanes % self.lanes_per_cluster:
            raise ValueError(
                f"n_lanes ({self.n_lanes}) must be a multiple of "
                f"lanes_per_cluster ({self.lanes_per_cluster}); use "
                f"with_lanes()/with_grid() which keep the grid consistent")
        if self.n_clusters % self.n_pods:
            raise ValueError(
                f"n_pods ({self.n_pods}) must divide the cluster count "
                f"({self.n_clusters})")
        # "flat", or the hierarchical model spelled at this machine's depth
        # (with_pods/with_lanes respell it when the depth changes)
        check_hierarchy(self.hierarchy, self.n_levels)

    # --- derived -----------------------------------------------------------
    @property
    def n_levels(self) -> int:
        """Topology depth: (cluster, lane), plus a pod level when grouped."""
        return 2 if self.n_pods == 1 else 3

    @property
    def n_clusters(self) -> int:
        """Total clusters across every pod (= the innermost level's group
        count; the Topology folds pods in the same way)."""
        return self.n_lanes // self.lanes_per_cluster

    @property
    def clusters_per_pod(self) -> int:
        return self.n_clusters // self.n_pods

    @property
    def vlmax(self) -> int:
        return self.vlen_bits // self.sew_bits

    @property
    def glsu_lat(self) -> float:
        """Memory request-response latency through the GLSU pipeline."""
        return self.vlsu_setup + 2.0 * self.glsu_regs

    @property
    def reqi_lat(self) -> float:
        return 2.0 * self.reqi_regs

    @property
    def hop_lat(self) -> float:
        """One inter-cluster RINGI hop (base + Fig 7(c) register cuts)."""
        return self.ring_hop + self.ringi_regs

    @functools.cached_property
    def topology(self) -> Topology:
        """The shared machine geometry — the *same* value
        ``repro_torch.core.machine.make_machine(topology=...)`` consumes.  Two
        levels (cluster, lane) for the paper's machine; (pod, cluster,
        lane) once ``n_pods > 1``.  Cached: the engine prices every sldu
        record through it."""
        if self.n_pods == 1:
            return Topology(self.n_clusters, self.lanes_per_cluster,
                            hierarchy=self.hierarchy,
                            intra_hop_lat=self.intra_hop,
                            inter_hop_lat=self.hop_lat)
        levels = (Level("pod", self.n_pods, self.pod_hop),
                  Level("cluster", self.clusters_per_pod, self.hop_lat),
                  Level("lane", self.lanes_per_cluster, self.intra_hop))
        return Topology(levels=levels, hierarchy=self.hierarchy)

    def slide_cost(self, hops: int) -> float:
        """Ring cycles before a slide by ``hops`` can stream (critical-path
        priced per wire level by the topology)."""
        return self.topology.slide_cost(hops)

    def hop_cost(self, src: int, dst: int) -> float:
        """Per-level price of one transfer between flattened ring positions
        (each link priced by the outermost boundary it crosses)."""
        return self.topology.hop_cost(src, dst)

    def red_tree_lat(self) -> float:
        """Inter-lane + inter-cluster (+ inter-pod) log-tree latency
        (vl-independent; this is exactly why reductions break weak scaling
        in Fig. 6).

        Hierarchical (§III-B.4, recursing outward): log2(L) intra-cluster
        A2A stages (the calibrated ``interlane_lat`` stage, not a bare wire
        hop), then one log-tree per outer level — log2(size) stages on that
        level's own ring, stage s riding s hops — so the wires that scale
        with the machine never see inner-level traffic.  flat: the same
        log-tree run over the whole flattened ring, every stage at the
        longest-wire price, which is what makes it strictly more expensive
        than the hierarchy whenever L > 1 (the paper's scalability claim).
        The wire cycles come from the shared Topology; this method only
        adds the per-stage FPU and final-SIMD terms.
        """
        topo = self.topology
        if self.hierarchy == "flat":
            n_stages = sum(1 for _ in Topology.tree_stages(self.n_lanes))
            return (topo.tree_wire_cycles() + n_stages * self.fpu_lat
                    + self.simd_red_cycles)
        inner = topo.levels[-1]
        n_lane_stages = sum(1 for _ in Topology.tree_stages(inner.size))
        total = (n_lane_stages * (self.interlane_lat + self.fpu_lat)
                 + self.simd_red_cycles)
        for lvl in topo.levels[:-1]:
            stages = list(Topology.tree_stages(lvl.size))
            total += sum(s * lvl.hop_lat for s in stages)
            total += len(stages) * self.fpu_lat
        return total

    def _respelled_hierarchy(self, n_pods: int) -> str:
        """The hierarchy spelling for a machine of ``n_pods`` depth (flat
        stays flat; the hierarchical model is renamed to the new depth)."""
        if self.hierarchy == "flat":
            return "flat"
        return hier_name(2 if n_pods == 1 else 3)

    def with_lanes(self, n_lanes: int) -> "AraXLParams":
        freq = 1.4 if n_lanes <= 32 else 1.15
        # Clamp the cluster size for tiny configs (n_lanes < lanes_per_cluster
        # used to keep lpc=4 and misprice n_clusters/red_tree_lat); gcd both
        # clamps and guarantees the divisibility the constructor validates.
        lpc = math.gcd(n_lanes, self.lanes_per_cluster)
        pods = math.gcd(n_lanes // lpc, self.n_pods)
        return dataclasses.replace(
            self, n_lanes=n_lanes, lanes_per_cluster=lpc, n_pods=pods,
            hierarchy=self._respelled_hierarchy(pods), freq_ghz=freq)

    def with_grid(self, n_clusters: int, lanes_per_cluster: int
                  ) -> "AraXLParams":
        """Re-factorise the machine as C x L (total lanes = C*L)."""
        pods = math.gcd(n_clusters, self.n_pods)
        return dataclasses.replace(
            self, n_lanes=n_clusters * lanes_per_cluster,
            lanes_per_cluster=lanes_per_cluster, n_pods=pods,
            hierarchy=self._respelled_hierarchy(pods))

    def with_pods(self, n_pods: int) -> "AraXLParams":
        """Group the clusters into ``n_pods`` pods (1 restores the paper's
        two-level machine).  The hierarchy spelling follows the depth."""
        return dataclasses.replace(
            self, n_pods=n_pods,
            hierarchy=self._respelled_hierarchy(n_pods))

    def with_hierarchy(self, hierarchy: str) -> "AraXLParams":
        return dataclasses.replace(self, hierarchy=hierarchy)

    def with_cuts(self, glsu: int = 0, reqi: int = 0, ringi: int = 0) -> "AraXLParams":
        return dataclasses.replace(self, glsu_regs=glsu, reqi_regs=reqi,
                                   ringi_regs=ringi)


def araxl_params(n_lanes: int = 64, *, lanes_per_cluster: int | None = None,
                 hierarchy: str | None = None,
                 n_pods: int | None = None) -> AraXLParams:
    p = AraXLParams().with_lanes(n_lanes)
    if lanes_per_cluster is not None:
        if n_lanes % lanes_per_cluster:
            raise ValueError(f"lanes_per_cluster ({lanes_per_cluster}) must "
                             f"divide n_lanes ({n_lanes})")
        p = p.with_grid(n_lanes // lanes_per_cluster, lanes_per_cluster)
    if n_pods is not None:
        p = p.with_pods(n_pods)
    if hierarchy is not None:
        p = p.with_hierarchy(hierarchy)
    return p


def ara2_params(n_lanes: int = 8) -> AraXLParams:
    """The original Ara2 as the paper's baseline: a single 'cluster' of n
    lanes (flat all-to-all units — no ring, no GLSU pipeline), VLEN=16 Kibit,
    1.08 GHz typical (16L; 8L also timed ~1.08-1.26, we use the paper's
    normalisation machine: 8-lane Ara2)."""
    return AraXLParams(
        name="ara2", n_lanes=n_lanes, lanes_per_cluster=n_lanes,
        vlen_bits=16384, freq_ghz=1.08,
        vlsu_setup=10.0,              # single-cycle A2A align/shuffle, short path
        ring_hop=0.0, intra_hop=0.0, interlane_lat=2.0,
    )
