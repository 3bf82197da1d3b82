"""RVV-flavoured vector ISA over the distributed register file.

Two interchangeable machines expose the same instruction surface:

* :class:`AraXLMachine` runs on a process mesh: element-wise ops are
  rank-local on the striped layout, slides and reductions ride the RINGI
  (``core.ring``), loads and stores the GLSU (``core.glsu``).  Every rank
  runs the same program on its own column (the REQI analogue: one SPMD
  program broadcast to every cluster).
* :class:`repro_torch.sim.trace.TraceMachine` has the same surface and no
  data: it appends instruction records that the cycle model replays.

The six paper kernels (``core.isa_kernels``) are written once against this
surface and run on either machine.  The port's counterpart of
``repro.core.isa``, with the same op names, units, FLOPs an element and
records.

The paper's fast set runs at full throughput: unit-stride loads and
stores, slide-by-1, reductions, basic mask ops.  Arbitrary slides take the
slow path, as in the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.parallel import comm

from . import glsu, ring
from .layout import VReg, VectorMachineSpec, global_index_grid, valid_mask


@dataclasses.dataclass
class InstrRecord:
    """One issued vector instruction (consumed by ``repro_torch.sim``)."""
    op: str            # mnemonic, e.g. "vfmacc.vf"
    vl: int            # element count
    unit: str          # fpu | valu | vlsu | sldu | masku | redu
    flops_per_elem: float = 0.0
    meta: dict | None = None


class AraXLMachine:
    """Executor of the vector ISA on a hierarchical process mesh.

    ``glsu_mode`` ("staged" or "direct") and ``reduce_mode`` ("ring" or
    "xla") pick the paper's staged and ring implementations or the flat
    collectives (the ablation switch); ``hierarchy`` ("flat", or the spec's
    depth spelled out: "two-level", "three-level", ...) picks the flattened
    lane ring or one ring a topology level, for the staged Align network
    and the ring reductions, by default the hierarchy of the spec's
    :class:`repro_torch.topology.Topology`.  Registers live on ``device``.
    Reductions and ``vcpop`` return 0-d tensors with the same bits on every
    rank; ``vse`` returns the whole memory vector on every rank.
    """

    #: ops counted with >1 flop/element (paper Table I: exp is a 7-term
    #: polynomial + range reduction -> 28 FLOP per element over 21 cycles).
    _EXP_FLOPS = 28.0

    def __init__(self, spec: VectorMachineSpec, *, glsu_mode: str = "staged",
                 reduce_mode: str = "ring", hierarchy: Optional[str] = None,
                 dtype=torch.float32, trace: Optional[list] = None,
                 device="cuda"):
        self.spec = spec
        self.glsu_mode = glsu_mode
        self.reduce_mode = reduce_mode
        self.hierarchy = (hierarchy if hierarchy is not None
                          else spec.topology.hierarchy)
        self.dtype = dtype
        self.trace = trace
        self.device = torch.device(device)

    # -- bookkeeping --------------------------------------------------------
    @property
    def vlmax(self) -> int:
        return self.spec.vlen_elems

    def _rec(self, op: str, vl: int, unit: str, fpe: float = 0.0, **meta):
        if self.trace is not None:
            self.trace.append(InstrRecord(op, vl, unit, fpe, meta or None))

    def _pad_len(self, vl: int) -> int:
        n = self.spec.n_total_lanes
        quantum = n * n if self.glsu_mode == "staged" else n
        return ((vl + quantum - 1) // quantum) * quantum

    def _rows(self, vl: int) -> int:
        return self._pad_len(vl) // self.spec.n_total_lanes

    def _operand(self, b):
        """A register's column, or a scalar (a Python number or a 0-d
        tensor such as a reduction's result) as a 0-d tensor in the
        machine's dtype on its device."""
        if isinstance(b, VReg):
            return b.data
        return torch.as_tensor(b, dtype=self.dtype, device=self.device)

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=self.dtype, device=self.device)

    # -- loads / stores (GLSU) ----------------------------------------------
    def vle(self, x, vl: int | None = None) -> VReg:
        """Load the memory vector ``x`` (numpy or a tensor, whole on every
        rank): this rank keeps its contiguous shard (the reference's
        ``mem_spec``), moves it to its device and routes it through the
        GLSU into its column."""
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        x = x.to(self.dtype).reshape(-1)
        vl = int(x.shape[0]) if vl is None else vl
        pvl = self._pad_len(vl)
        if x.shape[0] < pvl:
            x = torch.cat([x, x.new_zeros(pvl - x.shape[0])])
        B, p = pvl // self.spec.n_total_lanes, self.spec.ring_pos
        shard = x[p * B:(p + 1) * B].to(self.device)
        data = glsu.mem_to_reg(self.spec, shard, self.glsu_mode, self.hierarchy)
        self._rec("vle64.v", vl, "vlsu")
        return VReg(data, vl)

    def vse(self, r: VReg) -> torch.Tensor:
        """Store: GLSU to this rank's memory shard, then an all-gather over
        the ring, so every rank holds the first ``vl`` elements."""
        shard = glsu.reg_to_mem(self.spec, r.data, self.glsu_mode,
                                self.hierarchy)
        out = comm.all_gather_raw(shard, self.spec.ring_axes, self.spec.mesh, 0)
        self._rec("vse64.v", r.vl, "vlsu")
        return out[: r.vl]

    # -- register constructors ----------------------------------------------
    def vbrd(self, value, vl: int) -> VReg:
        data = self._operand(value).expand(self._rows(vl)).clone()
        r = VReg(data, vl)
        if vl < self._pad_len(vl):          # keep the tail architecturally zero
            r = VReg(torch.where(valid_mask(self.spec, r), data, self._zero()), vl)
        self._rec("vmv.v.x", vl, "valu")
        return r

    def vid(self, vl: int) -> VReg:
        idx = global_index_grid(self.spec, self._rows(vl),
                                device=self.device).to(self.dtype)
        idx = torch.where(idx < vl, idx, self._zero())
        self._rec("vid.v", vl, "valu")
        return VReg(idx, vl)

    # -- elementwise (lane-local, no communication) --------------------------
    def _ew2(self, op: str, unit: str, f, a: VReg, b, fpe=1.0) -> VReg:
        vl = a.vl if not isinstance(b, VReg) else min(a.vl, b.vl)
        out = f(a.data, self._operand(b))
        self._rec(op, vl, unit, fpe)
        return VReg(out.to(self.dtype), vl)

    def vadd(self, a: VReg, b) -> VReg:
        return self._ew2("vfadd" if self.dtype.is_floating_point else "vadd",
                         "fpu", torch.add, a, b)

    def vsub(self, a: VReg, b) -> VReg:
        return self._ew2("vfsub", "fpu", torch.sub, a, b)

    def vmul(self, a: VReg, b) -> VReg:
        return self._ew2("vfmul", "fpu", torch.mul, a, b)

    def vdiv(self, a: VReg, b) -> VReg:
        return self._ew2("vfdiv", "fpu", torch.div, a, b)

    def vmax(self, a: VReg, b) -> VReg:
        return self._ew2("vfmax", "fpu", torch.maximum, a, b)

    def vmin(self, a: VReg, b) -> VReg:
        return self._ew2("vfmin", "fpu", torch.minimum, a, b)

    def vfma(self, a: VReg, b, c) -> VReg:
        """a*b + c (vv or vf by b's type), rounded twice as the reference's
        two ops are. One FMA = 2 FLOP."""
        out = a.data * self._operand(b) + self._operand(c)
        self._rec("vfmacc", a.vl, "fpu", 2.0)
        return VReg(out.to(self.dtype), a.vl)

    def vfmacc_vf(self, acc: VReg, scalar, v: VReg) -> VReg:
        out = acc.data + self._operand(scalar) * v.data
        self._rec("vfmacc.vf", v.vl, "fpu", 2.0)
        return VReg(out.to(self.dtype), v.vl)

    def vexp(self, a: VReg) -> VReg:
        out = torch.where(valid_mask(self.spec, a), torch.exp(a.data), self._zero())
        self._rec("vexp(poly)", a.vl, "fpu", self._EXP_FLOPS)
        return VReg(out.to(self.dtype), a.vl)

    # -- masks (MASKU: same layout as data => local) -------------------------
    def vmslt(self, a: VReg, b) -> VReg:
        return self._ew2("vmslt", "masku", torch.lt, a, b, fpe=0.0)

    def vmsge(self, a: VReg, b) -> VReg:
        return self._ew2("vmsge", "masku", torch.ge, a, b, fpe=0.0)

    def vmerge(self, mask: VReg, a: VReg, b) -> VReg:
        out = torch.where(mask.data.bool(), a.data, self._operand(b))
        self._rec("vmerge", a.vl, "masku")
        return VReg(out.to(self.dtype), a.vl)

    def vcpop(self, mask: VReg) -> torch.Tensor:
        live = mask.data.bool() & valid_mask(self.spec, mask)
        self._rec("vcpop", mask.vl, "masku")
        return comm.psum(live.sum(), self.spec.ring_axes, self.spec.mesh)

    # -- slides (RINGI) -------------------------------------------------------
    def vslide1down(self, a: VReg, fill=0.0) -> VReg:
        out = ring.slide1down(self.spec, a.data, fill)
        self._rec("vfslide1down", a.vl, "sldu", meta={"hops": 1})
        return VReg(out, a.vl)

    def vslide1up(self, a: VReg, fill=0.0) -> VReg:
        out = ring.slide1up(self.spec, a.data, fill)
        self._rec("vfslide1up", a.vl, "sldu", meta={"hops": 1})
        return VReg(out, a.vl)

    def vslidedown(self, a: VReg, k: int) -> VReg:
        n = self.spec.n_total_lanes
        out = ring.slidedown_local(a.data, self.spec.ring_axes, n, k,
                                   self.spec.mesh, 0.0)
        self._rec("vslidedown.vx", a.vl, "sldu", meta={"hops": k % n})
        return VReg(out, a.vl)

    # -- reductions (intra-lane -> inter-lane -> inter-cluster log tree) ------
    def vredsum(self, a: VReg) -> torch.Tensor:
        masked = torch.where(valid_mask(self.spec, a), a.data, self._zero())
        out = ring.reduce_scalar(self.spec, masked.to(self.dtype), "sum",
                                 self.reduce_mode, self.hierarchy)
        self._rec("vfredsum", a.vl, "redu", 1.0)
        return out

    def vredmax(self, a: VReg) -> torch.Tensor:
        neg = torch.full((), -torch.inf, dtype=self.dtype, device=self.device)
        masked = torch.where(valid_mask(self.spec, a), a.data, neg)
        out = ring.reduce_scalar(self.spec, masked.to(self.dtype), "max",
                                 self.reduce_mode, self.hierarchy)
        self._rec("vfredmax", a.vl, "redu", 1.0)
        return out

    # -- stripmining ----------------------------------------------------------
    def stripmine(self, total: int, lmul: int = 1):
        """Yield (offset, vl) chunks, RVV vsetvli-style."""
        step = self.vlmax * lmul
        off = 0
        while off < total:
            vl = min(step, total - off)
            self._rec("vsetvli", vl, "seq")
            yield off, vl
            off += vl
