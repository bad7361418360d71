"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

A function, never a module-level constant: importing this module touches
no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def make_host_mesh(device=None) -> DeviceMesh:
    """A (W, 1) mesh with dimensions ("data", "model") over the default
    process group of W ranks, on ``device`` (the CUDA card unless the
    caller passes a CPU device). With no process group yet, it first makes
    a world-size-1 group from a local store, so a single process needs no
    launcher. Use it as ``with make_host_mesh(): solve(...,
    batching=Sharded("data"))``; every rank of the group must call it."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        # one process needs no rendezvous: a local store
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    return DeviceMesh(dev.type, torch.arange(world).reshape(world, 1),
                      mesh_dim_names=("data", "model"))


__all__ = ["make_host_mesh"]
