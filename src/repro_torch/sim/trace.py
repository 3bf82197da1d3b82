"""TraceMachine — the data-free twin of ``repro_torch.core.isa.AraXLMachine``.

Exposes the same instruction surface but only records
:class:`repro_torch.core.isa.InstrRecord`s with *real register dependencies*
(every virtual register / scalar result carries an id), so the pipeline
model chains exactly the way the hardware would, not by program order.

When constructed with a :class:`repro_torch.topology.Topology`, every slide is
additionally tagged with the wire level its critical path crosses
(``meta["level"]`` — ``"intra"``/``"inter"`` on the paper's two-level
machine, the level's own name, e.g. ``"pod"``, further out) so the engine's
per-level hop pricing and the hierarchy ablations can attribute RINGI
traffic to the right wires.
"""
from __future__ import annotations

import itertools

from repro_torch.core.isa import InstrRecord
from repro_torch.topology import Topology


class _TraceReg:
    __slots__ = ("vl", "id")

    def __init__(self, vl: int, rid: int):
        self.vl = vl
        self.id = rid


class _ScalarResult(float):
    """A float that remembers which instruction produced it (reduction
    results consumed by later vector ops through the scalar core)."""
    def __new__(cls, rid: int):
        obj = super().__new__(cls, 0.0)
        obj.id = rid
        return obj


def _dep(x):
    rid = getattr(x, "id", None)
    return (rid,) if rid is not None else ()


class TraceMachine:
    _EXP_FLOPS = 28.0

    def __init__(self, vlen_bits: int = 65536, sew_bits: int = 64,
                 topology: Topology | None = None):
        self.vlen_bits = vlen_bits
        self.sew_bits = sew_bits
        self.topology = topology
        self.trace: list[InstrRecord] = []
        self._ids = itertools.count(1)

    def _slide_meta(self, hops: int) -> dict:
        meta = {"hops": hops}
        if self.topology is not None:
            meta["level"] = self.topology.slide_level(hops)
        return meta

    @property
    def vlmax(self) -> int:
        return self.vlen_bits // self.sew_bits

    def _rec(self, op, vl, unit, fpe=0.0, deps=(), **meta):
        rid = next(self._ids)
        m = dict(meta) if meta else {}
        m["out"] = rid
        m["deps"] = tuple(d for d in deps if d is not None)
        self.trace.append(InstrRecord(op, int(vl), unit, fpe, m))
        return _TraceReg(int(vl), rid)

    # scalar-core side events (issue model input)
    def scalar_load(self, n: int = 1):
        self.trace.append(InstrRecord("ld", n, "scalar"))

    def scalar_op(self, n: int = 1):
        self.trace.append(InstrRecord("sop", n, "scalar"))

    # ISA surface ----------------------------------------------------------
    def vle(self, x=None, vl=None):
        vl = int(vl if vl is not None else len(x))
        return self._rec("vle64.v", vl, "vlsu")

    def vse(self, r):
        self._rec("vse64.v", r.vl, "vlsu", deps=_dep(r))
        return None

    def vbrd(self, value, vl):
        return self._rec("vmv.v.x", vl, "valu", deps=_dep(value))

    def vid(self, vl):
        return self._rec("vid.v", vl, "valu")

    def _ew(self, op, a, b=None, unit="fpu", fpe=1.0):
        return self._rec(op, a.vl, unit, fpe, deps=_dep(a) + _dep(b))

    def vadd(self, a, b):   return self._ew("vfadd", a, b)
    def vsub(self, a, b):   return self._ew("vfsub", a, b)
    def vmul(self, a, b):   return self._ew("vfmul", a, b)
    def vdiv(self, a, b):   return self._ew("vfdiv", a, b)
    def vmax(self, a, b):   return self._ew("vfmax", a, b)
    def vmin(self, a, b):   return self._ew("vfmin", a, b)

    def vfma(self, a, b, c):
        return self._rec("vfmacc", a.vl, "fpu", 2.0,
                         deps=_dep(a) + _dep(b) + _dep(c))

    def vfmacc_vf(self, acc, scalar, v):
        return self._rec("vfmacc.vf", v.vl, "fpu", 2.0,
                         deps=_dep(acc) + _dep(scalar) + _dep(v))

    def vexp(self, a):
        return self._rec("vexp(poly)", a.vl, "fpu", self._EXP_FLOPS,
                         deps=_dep(a))

    def vmslt(self, a, b):  return self._ew("vmslt", a, b, "masku", 0.0)
    def vmsge(self, a, b):  return self._ew("vmsge", a, b, "masku", 0.0)

    def vmerge(self, m, a, b):
        return self._rec("vmerge", a.vl, "masku",
                         deps=_dep(m) + _dep(a) + _dep(b))

    def vcpop(self, m):
        rid = self._rec("vcpop", m.vl, "masku", deps=_dep(m))
        return _ScalarResult(rid.id)

    def vslide1down(self, a, fill=0.0):
        return self._rec("vfslide1down", a.vl, "sldu", deps=_dep(a),
                         **self._slide_meta(1))

    def vslide1up(self, a, fill=0.0):
        return self._rec("vfslide1up", a.vl, "sldu", deps=_dep(a),
                         **self._slide_meta(1))

    def vslidedown(self, a, k):
        return self._rec("vslidedown.vx", a.vl, "sldu", deps=_dep(a),
                         **self._slide_meta(k))

    def vredsum(self, a):
        r = self._rec("vfredsum", a.vl, "redu", 1.0, deps=_dep(a))
        return _ScalarResult(r.id)

    def vredmax(self, a):
        r = self._rec("vfredmax", a.vl, "redu", 1.0, deps=_dep(a))
        return _ScalarResult(r.id)

    def stripmine(self, total, lmul: int = 1):
        step = self.vlmax * lmul
        off = 0
        while off < total:
            vl = min(step, total - off)
            yield off, vl
            off += vl
