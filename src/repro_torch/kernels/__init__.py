"""Kernels of the port: each a hand-written Hopper kernel beside its plain
PyTorch version (``ref``), reached through ``ops``."""
