"""repro_torch: the MALI reproduction on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that imports nothing of it. Entry
points compute on the CUDA card unless the caller passes a CPU device.
``repro_torch.core`` is ``solve()`` with every solver, controller and
gradient method, events and the Lockstep, PerSample and Sharded batching
modes; ``repro_torch.cnf`` the
continuous normalizing flows; ``repro_torch.models`` is the
continuous-depth LM (its training loss, prefill and decode);
``repro_torch.train`` trains it (optimizers in ``repro_torch.optim``,
checkpoints in ``repro_torch.checkpoint``; ``python -m
repro_torch.launch.train``).
The fused ALF state updates, RMSNorm and prompt attention run as
hand-written CUDA kernels (``repro_torch.kernels``), built with ``nvcc``
at first use.
"""
from .convert import params_from_numpy, params_to_numpy
from .device import default_device

__all__ = ["default_device", "params_from_numpy", "params_to_numpy"]
