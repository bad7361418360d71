"""End-to-end driver: train a continuous-depth LM with MALI through the
repro_torch.train subsystem (config -> Trainer -> checkpoint -> fault
recovery), then serve from the trained weights (the port of
``examples/lm_continuous_depth.py``).

    PYTHONPATH=src python -m repro_torch.examples.lm_continuous_depth \\
        [--arch qwen3-1.7b] [--steps 120] [--device cpu]

This is the paper's §4.2 protocol transplanted to the LM substrate: the
SAME per-block dynamics f is trained (a) discrete (y = x + f(x), the
"ResNet") and (b) continuous (y = x + int f dt, MALI) — losses should land
in the same regime at equal parameter count; (b) runs at O(1) activation
memory in ODE steps. The third phase kills the run mid-step and lets the
Trainer recover from its checkpoint: the resumed loss trace matches the
uninterrupted one step-for-step (resumable MALI state). On the card the
ODE branches run ALF on the kernels (``ode_backend="auto"``).
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu')")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))
    every = max(args.steps // 3, 1)

    def config(d, **kw):
        return TrainerConfig(arch=args.arch, smoke=True, steps=args.steps,
                             global_batch=8, seq_len=64, ckpt_dir=d,
                             ckpt_every=every, device=dev, **kw)

    with tempfile.TemporaryDirectory() as d:
        print("=== continuous-depth (MALI, 2 ODE steps/block) ===")
        clean = Trainer(config(d + "/node", ode=True, ode_steps=2))
        t0 = time.perf_counter()
        assert clean.train() == args.steps
        step_ms = (time.perf_counter() - t0) / args.steps * 1e3

        print("=== discrete baseline (same params, ode off) ===")
        discrete = Trainer(config(d + "/discrete", ode=False))
        discrete.train()

        print("=== fault-injected recovery (kill mid-run, resume) ===")
        crash_at = {"step": args.steps // 2, "armed": True}

        def hook(step):
            if crash_at["armed"] and step == crash_at["step"]:
                crash_at["armed"] = False
                raise RuntimeError("injected node failure")

        faulted = Trainer(config(d + "/faulted", ode=True, ode_steps=2),
                          step_hook=hook)
        assert faulted.train() == args.steps
        assert faulted.loss_trace() == clean.loss_trace(), \
            "recovered run must reproduce the uninterrupted loss trace"
        print("loss-trace continuity after recovery: OK")

    print("=== serve from a continuous-depth model ===")
    served = serve(args.arch, smoke=True, ode=True, prompt_len=16,
                   decode_tokens=8, batch=2, device=dev)
    return {"clean": clean.loss_trace(), "discrete": discrete.loss_trace(),
            "faulted": faulted.loss_trace(), "serve_tokens": served.tokens,
            "step_ms": step_ms}


if __name__ == "__main__":
    main()
