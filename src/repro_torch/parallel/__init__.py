"""Distributed compute on a process mesh: the rule table (``sharding``),
the collectives (``comm``) and ring attention (``ring_attention``)."""
from .comm import Mesh, init_world
from .sharding import (PV, ShardingRules, default_rules, gather_tree,
                       init_local_params, logical_to_spec, param_placements,
                       shard_tree)

__all__ = ["Mesh", "init_world", "PV", "ShardingRules", "default_rules",
           "logical_to_spec", "param_placements", "shard_tree", "gather_tree",
           "init_local_params"]
