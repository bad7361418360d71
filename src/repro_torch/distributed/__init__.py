"""Data parallelism over ``torch.distributed`` device meshes: the JAX
package's sharding rules, their execution over a process group (ZeRO-1
optimizer state, gradient collectives), the ambient mesh of ``Sharded``
batching and its row collectives, elastic re-meshing and the training
loop's restart-on-failure."""
from .fault_tolerance import (MeshPlan, RecoveryStats, plan_elastic_mesh,
                              reassign_shards, run_with_recovery)
from .sharding import (Spec, ambient_mesh, batch_shardings, gather_rows,
                       mark_replicated, opt_state_shardings,
                       param_shardings, zero1_sharding)

__all__ = ["Spec", "ambient_mesh", "batch_shardings", "gather_rows",
           "mark_replicated", "opt_state_shardings", "param_shardings",
           "zero1_sharding", "MeshPlan", "RecoveryStats",
           "plan_elastic_mesh", "reassign_shards", "run_with_recovery"]
