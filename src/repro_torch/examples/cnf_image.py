"""Paper §4.4 at image scale: FFJORD-class CNF on MNIST-shaped data,
trained with MALI + ALF(backend='cuda') under Sharded batching (the port
of ``examples/cnf_image.py``).

    PYTHONPATH=src python -m repro_torch.examples.cnf_image [--steps 20] \\
        [--n-steps 8] [--batch 16] [--hidden 64] [--device cpu]

The flow integrates the 784-dimensional augmented state with the
Hutchinson trace estimator (one JVP per state, fixed probe per solve) and
reports bits/dim. The Sharded batching axis splits the solve over the
host mesh's 'data' axis (one rank here: ``make_host_mesh`` makes a
world-size-1 group when none exists), and MALI keeps the backward
residual at O(T * N_z) regardless of the step count.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.cnf import CNF, Hutchinson, bits_per_dim, cnf_loss
from repro_torch.core import ALF, ConstantSteps, Lockstep, MALI, Sharded
from repro_torch.data import DataConfig, make_image_batch
from repro_torch.device import resolve_device
from repro_torch.examples._common import Adam
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_mlp_vfield, mlp_vfield

DIM = 28 * 28
KINETIC_REG = 0.05  # the paper's §4.4 image-scale coefficient
# the JAX example's defaults and fixed settings
STEPS, N_STEPS, BATCH, HIDDEN = 20, 8, 16, 64
DEPTH = 2           # hidden layers of the field
LR = 1e-3


def dequantized_batch(dcfg, step, rng, device=None):
    """256-level quantized images + uniform dequantization noise — the
    standard continuous-likelihood protocol behind bits/dim; the noise
    drawn from ``rng`` as the JAX example draws it."""
    img = make_image_batch(dcfg, step)["image"]
    x = img + rng.uniform(0, 1.0 / 256.0, img.shape)
    return torch.as_tensor(x.astype(np.float32),
                           device=resolve_device(device))


def loss_fn(flow, p, x, generator, n_steps, batching):
    """The training objective and the log-prob result: ALF on the
    kernels, ConstantSteps(n_steps), MALI, ``batching``."""
    res = flow.log_prob(p, x, generator, solver=ALF(backend="cuda"),
                        controller=ConstantSteps(n_steps), gradient=MALI(),
                        batching=batching)
    return cnf_loss(res, kinetic_reg=KINETIC_REG), res


def train_step(flow, opt, x, generator, i, n_steps, batching):
    """One Adam step of ``opt`` (in place); returns the loss and the
    log-prob result."""
    loss, res = loss_fn(flow, opt.params, x, generator, n_steps, batching)
    opt.step(opt.grads(loss), i)
    return loss.detach(), res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--n-steps", type=int, default=N_STEPS,
                    help="ODE steps per solve (h = 1/n)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--hidden", type=int, default=HIDDEN)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mesh = make_host_mesh(dev)
    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    batch = args.batch - args.batch % n_data or n_data
    dcfg = DataConfig(seed=0, global_batch=batch)
    rng = np.random.default_rng(0)

    flow = CNF(mlp_vfield, dim=DIM, estimator=Hutchinson())
    batching = Sharded(axis="data", inner=Lockstep())
    fp = init_mlp_vfield(torch.Generator(device=dev).manual_seed(0), DIM,
                         hidden=args.hidden, depth=DEPTH, device=dev)
    opt = Adam(fp, LR)

    losses, bpds = [], []
    t0 = time.perf_counter()
    with mesh:
        for i in range(args.steps):
            x = dequantized_batch(dcfg, i, rng, dev)
            probe = torch.Generator(device=dev).manual_seed(i)
            loss, res = train_step(flow, opt, x, probe, i, args.n_steps,
                                   batching)
            losses.append(float(loss))
            bpds.append(float(bits_per_dim(res, DIM).detach()))
            if i % 5 == 0 or i == args.steps - 1:
                print(f"step {i:3d}  loss={losses[-1]:9.3f}  "
                      f"bits/dim={bpds[-1]:7.3f}")
        step_ms = (time.perf_counter() - t0) / max(args.steps, 1) * 1e3
        print(f"residual bytes (MALI, n_steps={args.n_steps}): "
              f"{int(res.solution.stats.residual_bytes)} "
              "(O(T * N_z): constant in the step count)")

    assert all(math.isfinite(b) for b in bpds), "training diverged"
    assert bpds[-1] < bpds[0], "bits/dim must improve over training"
    print(f"bits/dim first={bpds[0]:.3f} last={bpds[-1]:.3f}  OK")
    return {"losses": losses, "bpds": bpds, "batch": batch,
            "residual_bytes": int(res.solution.stats.residual_bytes),
            "step_ms": step_ms}


if __name__ == "__main__":
    main()
