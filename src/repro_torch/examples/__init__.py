"""Twins of the repo's ``examples/`` drivers, run as modules."""
