"""repro_torch.parallel — the sharding rules over ``torch.distributed``'s
``DeviceMesh`` (port of ``repro/parallel``)."""
from .sharding import (NamedSharding, ShardingRules, active_rules, axis_size,
                       current_mesh, local_bytes, make_rules, mesh_shape,
                       prune_batch_axes, rules_for, tree_shardings,
                       use_mesh, use_rules)

__all__ = ["NamedSharding", "ShardingRules", "active_rules", "axis_size",
           "current_mesh", "local_bytes", "make_rules", "mesh_shape",
           "prune_batch_axes", "rules_for", "tree_shardings", "use_mesh",
           "use_rules"]
