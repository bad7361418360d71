"""Data parallelism over ``torch.distributed`` device meshes: the ambient
mesh of ``Sharded`` batching and its row-sharding collectives."""
from .sharding import ambient_mesh, gather_rows, replicated

__all__ = ["ambient_mesh", "gather_rows", "replicated"]
