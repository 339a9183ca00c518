"""repro_torch.parallel — the sharding rules over ``torch.distributed``'s
``DeviceMesh``, ``constrain`` and the collectives of a sharded step (port
of ``repro/parallel``)."""
from .sharding import (NamedSharding, ShardingRules, active_rules,
                       all_gather, all_to_all, axis_index, axis_size,
                       constrain, current_mesh, local_bytes, local_shard,
                       make_rules, mesh_shape, named_sharding, pmax,
                       prune_batch_axes, psum, rules_for, shard_tree,
                       spmd_rules, tree_shardings, use_mesh, use_rules)

__all__ = ["NamedSharding", "ShardingRules", "active_rules", "all_gather",
           "all_to_all", "axis_index", "axis_size", "constrain",
           "current_mesh", "local_bytes", "local_shard", "make_rules",
           "mesh_shape", "named_sharding", "pmax", "prune_batch_axes",
           "psum", "rules_for", "shard_tree", "spmd_rules", "tree_shardings",
           "use_mesh", "use_rules"]
