"""The roofline of a cell (the arithmetic of ``repro.roofline``)."""
from .analysis import (HW, collective_bytes, collective_level_bytes,
                       roofline_terms, wire_seconds)

__all__ = ["HW", "collective_bytes", "collective_level_bytes", "roofline_terms",
           "wire_seconds"]
