"""Data parallelism over ``torch.distributed`` device meshes (the ambient
mesh of ``Sharded`` batching and its row-sharding collectives) and the
training loop's restart-on-failure."""
from .fault_tolerance import RecoveryStats, run_with_recovery
from .sharding import ambient_mesh, gather_rows, replicated

__all__ = ["ambient_mesh", "gather_rows", "replicated", "RecoveryStats",
           "run_with_recovery"]
