"""AraXL core on a process mesh: the distributed long-vector register file,
the ring interconnect, the staged GLSU and the vector ISA (the port's
counterpart of ``repro.core``; a lane is a rank)."""
from repro_torch.topology import Topology
from .isa import AraXLMachine, InstrRecord
from .layout import (VReg, VectorLayout, VectorMachineSpec, coords_to_element,
                     element_to_coords)
from .machine import make_machine, make_topology_mesh, make_vector_mesh

__all__ = [
    "AraXLMachine", "InstrRecord", "Topology", "VReg", "VectorLayout",
    "VectorMachineSpec", "coords_to_element", "element_to_coords",
    "make_machine", "make_topology_mesh", "make_vector_mesh",
]
