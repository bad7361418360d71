"""Paper §4.2 at CPU scale: residual net vs the SAME network as a
continuous-depth Neural ODE trained with MALI (the port of
``examples/image_recognition.py``).

    PYTHONPATH=src python -m repro_torch.examples.image_recognition \\
        [--steps 400] [--device cpu]

Synthetic 8x8 3-class "images" (license-free stand-in for Cifar; the paper's
mechanism — y = x + f(x) vs y = x + int_0^1 f(z)dt with SHARED f — is
architecture-faithful). Reports test accuracy for (a) the residual baseline,
(b) Neural-ODE+MALI, and (c) solver-invariance of (b) at inference. ALF
runs on ``backend="cuda"``: the kernels on the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import ALF
from repro_torch.core.api import odeint
from repro_torch.device import resolve_device
from repro_torch.examples._common import Adam

D = 64           # flattened 8x8 image
N_CLASS = 3
HIDDEN = 64


_PROTOS = np.random.default_rng(12345).standard_normal((N_CLASS, D)) * 0.6


def make_data(n, seed, device=None):
    """Three gaussian-blob classes (FIXED means shared by train/test) with
    pixel noise, drawn as the JAX example draws them: images (n, D)
    float32 and labels (n,) int64 on ``device``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, N_CLASS, n)
    x = _PROTOS[y] + rng.standard_normal((n, D)) * 0.8
    dev = resolve_device(device)
    return (torch.as_tensor(x.astype(np.float32), device=dev),
            torch.as_tensor(y, dtype=torch.int64, device=dev))


def init_params(generator: torch.Generator, device=None):
    """Seeded weights, drawn from ``generator`` (on ``device``)."""
    dev = resolve_device(device)

    def g(*shape):
        return 0.3 * torch.randn(shape, generator=generator, device=dev)

    return {
        "f": {"w1": g(D, HIDDEN), "b1": torch.zeros(HIDDEN, device=dev),
              "w2": g(HIDDEN, D), "b2": torch.zeros(D, device=dev)},
        "norm": torch.ones(D, device=dev),
        "head": g(D, N_CLASS),
        "bh": torch.zeros(N_CLASS, device=dev),
    }


def field(fp, z, t):
    """The shared residual function f(z) (t-independent, like a ResNet
    block)."""
    h = torch.tanh(z @ fp["w1"] + fp["b1"])
    return h @ fp["w2"] + fp["b2"]


def forward(params, x, mode, solver="alf", n_steps=4):
    if mode == "resnet":                       # y = x + f(x)
        z = x + field(params["f"], x, 0.0)
    else:                                      # y = x + int_0^1 f dt
        method = "mali" if solver == "alf" else "naive"
        z = odeint(field, params["f"], x, 0.0, 1.0, method=method,
                   solver=ALF(backend="cuda") if solver == "alf" else solver,
                   n_steps=n_steps)
    z = z * params["norm"]
    return z @ params["head"] + params["bh"]


def loss_fn(params, x, y, mode):
    logp = torch.log_softmax(forward(params, x, mode), -1)
    return -logp.gather(1, y[:, None]).mean()


def train(params, x, y, mode, steps, lr=3e-3):
    """``steps`` Adam steps from ``params`` (left as they are); returns
    the trained parameters and the last step's loss."""
    opt = Adam(params, lr)
    losses = []
    for i in range(steps):
        loss = loss_fn(opt.params, x, y, mode)
        opt.step(opt.grads(loss), i)
        losses.append(loss.detach())
    return opt.params, float(losses[-1])


@torch.no_grad()
def accuracy(params, x, y, mode, **kw):
    return float((forward(params, x, mode, **kw).argmax(-1) == y)
                 .float().mean())


INVARIANCE = (("alf", 4), ("alf", 8), ("euler", 8), ("rk4", 4),
              ("dopri5", 4))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    x, y = make_data(2048, seed=0, device=dev)
    xt, yt = make_data(1024, seed=1, device=dev)
    p0 = init_params(torch.Generator(device=dev).manual_seed(0), dev)
    out = {}

    for mode, label in (("resnet", "resnet     "), ("node", "node(MALI) ")):
        t0 = time.perf_counter()
        trained, loss = train(p0, x, y, mode, args.steps)  # ends in a sync
        step_ms = (time.perf_counter() - t0) / max(args.steps, 1) * 1e3
        acc = accuracy(trained, xt, yt, mode)
        print(f"{label} train_loss={loss:.4f} test_acc={acc:.3f}")
        out[mode] = {"train_loss": loss, "test_acc": acc,
                     "step_ms": step_ms}
    node = trained

    # solver invariance (paper Table 2): same weights, different solvers
    out["invariance"] = {}
    for solver, n in INVARIANCE:
        a = accuracy(node, xt, yt, "node", solver=solver, n_steps=n)
        print(f"  invariance: solver={solver:7s} n={n}  test_acc={a:.3f}")
        out["invariance"][f"{solver}_{n}"] = a
    return out


if __name__ == "__main__":
    main()
