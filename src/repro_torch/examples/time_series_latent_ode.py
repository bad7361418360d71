"""Paper §4.3 at CPU scale: latent ODE (Rubanova et al. 2019) for
irregularly-sampled time series, trained with MALI (the port of
``examples/time_series_latent_ode.py``).

    PYTHONPATH=src python -m repro_torch.examples.time_series_latent_ode \\
        [--steps 500] [--method mali] [--device cpu]

Encoder (GRU over observed points, reversed) -> latent z0 -> latent dynamics
integrated with MALI -> decoder -> MSE on held-out segment. Synthetic damped
2D oscillators with random frequencies/phases stand in for the Mujoco-Hopper
stream (same protocol: condition on the first half, extrapolate the rest).
ALF runs on ``backend="cuda"``: the kernels on the card.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.core import (ACA, ALF, Backsolve, ConstantSteps, Dopri5,
                              HeunEuler, MALI, Naive, SaveAt, solve)
from repro_torch.device import resolve_device
from repro_torch.examples._common import Adam

METHODS = {"mali": (MALI(), ALF(backend="cuda")),
           "naive": (Naive(), ALF(backend="cuda")),
           "aca": (ACA(), HeunEuler()), "adjoint": (Backsolve(), Dopri5())}

LATENT = 8
OBS = 2
HID = 32
T_OBS = 25     # conditioning points
T_EXT = 25     # extrapolation points


def make_series(n, seed, device=None):
    """Damped 2-D oscillators, drawn as the JAX example draws them: the
    series (n, T, 2) and the observation times (T,), float32 on
    ``device``."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.8, 2.0, (n, 1))
    phi = rng.uniform(0, 2 * np.pi, (n, 1))
    amp = rng.uniform(0.5, 1.5, (n, 1))
    t = np.linspace(0, 5, T_OBS + T_EXT)[None, :]
    x = amp * np.exp(-0.1 * t) * np.cos(w * t + phi)
    y = amp * np.exp(-0.1 * t) * np.sin(w * t + phi)
    series = np.stack([x, y], -1)   # [n, T, 2]
    dev = resolve_device(device)
    return (torch.as_tensor(series.astype(np.float32), device=dev),
            torch.as_tensor(t[0].astype(np.float32), device=dev))


def init_params(generator: torch.Generator, device=None):
    """Seeded weights, drawn from ``generator`` (on ``device``)."""
    dev = resolve_device(device)

    def g(*shape):
        return 0.3 * torch.randn(shape, generator=generator, device=dev)

    return {
        "enc_in": g(OBS, HID),
        "enc_h": g(HID, HID),
        "enc_out": g(HID, LATENT),
        "f": {"w1": g(LATENT + 1, HID), "b1": torch.zeros(HID, device=dev),
              "w2": g(HID, LATENT), "b2": torch.zeros(LATENT, device=dev)},
        "dec_w": g(LATENT, HID),
        "dec_w2": g(HID, OBS),
        "dec_b": torch.zeros(OBS, device=dev),
    }


def encode(params, obs):
    """Reverse-time RNN over the conditioning window -> z0."""
    h = obs.new_zeros(obs.shape[:-2] + (HID,))
    for x in obs.flip(-2).unbind(-2):
        h = torch.tanh(x @ params["enc_in"] + h @ params["enc_h"])
    return h @ params["enc_out"]


def latent_field(fp, z, t):
    t_col = torch.as_tensor(t, dtype=z.dtype, device=z.device).expand(
        z.shape[:-1] + (1,))
    h = torch.tanh(torch.cat([z, t_col], -1) @ fp["w1"] + fp["b1"])
    return h @ fp["w2"] + fp["b2"]


def decode(params, z):
    return torch.tanh(z @ params["dec_w"]) @ params["dec_w2"] \
        + params["dec_b"]


def rollout(params, z0, ts, method="mali"):
    """Integrate latent state to every observation time in ONE native-grid
    SaveAt(ts=...) solve (for MALI the backward residuals stay at the
    per-observation (z, v) pairs). Swapping the gradient method is a
    one-argument change."""
    gradient, solver = METHODS[method]
    return solve(latent_field, params["f"], z0, solver=solver,
                 controller=ConstantSteps(2), gradient=gradient,
                 saveat=SaveAt(ts=ts)).ys   # [T, ..., LATENT]


def loss_fn(p, data, ts, method="mali"):
    """Train MSE over the whole series, conditioned on its first T_OBS
    points."""
    z0 = encode(p, data[:, :T_OBS])
    zs = rollout(p, z0, ts, method=method)          # [T, B, L]
    pred = decode(p, zs.transpose(0, 1))            # [B, T, OBS]
    return torch.mean((pred - data) ** 2)


@torch.no_grad()
def extrapolation_mse(params, test, ts, method="mali"):
    """Held-out extrapolation MSE (the paper's Table 4 metric)."""
    zs = rollout(params, encode(params, test[:, :T_OBS]), ts, method=method)
    pred = decode(params, zs.transpose(0, 1))
    return float(torch.mean((pred[:, T_OBS:] - test[:, T_OBS:]) ** 2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--method", default="mali",
                    choices=["mali", "naive", "aca", "adjoint"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    series, ts = make_series(256, seed=0, device=dev)
    test, _ = make_series(128, seed=1, device=dev)
    opt = Adam(init_params(torch.Generator(device=dev).manual_seed(0), dev),
               5e-3)

    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = loss_fn(opt.params, series, ts, args.method)
        opt.step(opt.grads(loss), i)
        losses.append(loss.detach())
    losses = [float(v) for v in losses]                 # ends in a sync
    step_ms = (time.perf_counter() - t0) / max(args.steps, 1) * 1e3
    print(f"train MSE: first={losses[0]:.4f} last={losses[-1]:.4f}")

    ext_mse = extrapolation_mse(opt.params, test, ts, args.method)
    print(f"test extrapolation MSE ({args.method}): {ext_mse:.4f}")
    assert math.isfinite(ext_mse)
    return {"method": args.method, "losses": losses,
            "test_ext_mse": ext_mse, "step_ms": step_ms}


if __name__ == "__main__":
    main()
