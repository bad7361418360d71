"""Device meshes of the port (counterpart of ``repro.launch.mesh``): the
host mesh over the ranks that exist, and the production meshes.

A function, never a module-level constant: importing this module touches
no process group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


# (device, default process group) -> its host mesh: a DeviceMesh makes a
# process group for each of its dimensions, so it is made once
_HOST_MESHES: Dict[Tuple[str, Any], DeviceMesh] = {}


def make_host_mesh(device=None) -> DeviceMesh:
    """A (W, 1) mesh with dimensions ("data", "model") over the default
    process group of W ranks, on ``device`` (the CUDA card unless the
    caller passes a CPU device). Side effects, on the first call of a
    process: with no process group yet, it makes a world-size-1 group
    from a local store (NCCL on the card, gloo on the CPU), so a single
    process needs no launcher; on the card it makes ``device`` the
    current CUDA device (on every call). The mesh is made once for each
    device and default group and then reused. Use it as ``with
    make_host_mesh(): solve(..., batching=Sharded("data"))``; every rank
    of the group must call it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the mesh keeps an initialised device (it would otherwise pick
        # cuda:LOCAL_RANK, and ranks may share one card)
        if dev.index is not None:
            torch.cuda.set_device(dev)
        torch.cuda.init()
    if not dist.is_initialized():
        # one process needs no rendezvous: a local store
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    key = (str(dev), dist.group.WORLD)
    if key not in _HOST_MESHES:
        # the meshes of a destroyed default group go with it
        for old in [k for k in _HOST_MESHES if k[1] is not key[1]]:
            del _HOST_MESHES[old]
        world = dist.get_world_size()
        _HOST_MESHES[key] = DeviceMesh(
            dev.type, torch.arange(world).reshape(world, 1),
            mesh_dim_names=("data", "model"))
    return _HOST_MESHES[key]


def production_axes(*, multi_pod: bool = False) -> Dict[str, int]:
    """``{axis: size}`` of a production mesh: 16 x 16 ("data", "model"),
    or 2 x 16 x 16 ("pod", "data", "model")."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The JAX package's production meshes (:func:`production_axes`) over
    the default process group of 256 or 512 ranks. Raises ``ValueError``
    naming the world size needed otherwise. The Trainer trains on both
    (``production_mesh``, ``multi_pod``): their 16-way 'model' axis is
    tensor parallelism, and 'pod' x 'data' data parallelism with FSDP
    (:mod:`repro_torch.distributed.data_parallel`)."""
    axes = production_axes(multi_pod=multi_pod)
    shape = tuple(axes.values())
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production "
            f"mesh {shape} needs a world of {need} ranks, got {world}")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape),
                      mesh_dim_names=tuple(axes))


__all__ = ["make_host_mesh", "make_production_mesh", "production_axes"]
