"""Imported by every CPU test module of the port: torch on one intra-op
thread in the test process.

The tests run six xdist workers on a machine of eight cores, and many of
them spawn processes of their own (a mesh's ranks, the cluster's workers,
a launcher); with torch's default pool of one thread a core in every
worker, the pools spin against each other on the small tensors these tests
use.  The whole tier-1 suite (``-n 6 --dist loadfile`` on 8 cores) took
1,496 s with the default pools and 476 s with one thread a worker; an
emulated flash backward at S = 445 took 17 s against 0.15 s.  It changes
no check: the ranks of ``repro_torch.testing.subproc.run_ranks`` already
run on one thread each.
"""
import torch

torch.set_num_threads(1)
