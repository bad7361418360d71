"""Training CLI — a thin front end over :class:`repro_torch.train.Trainer`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 50 --ckpt-dir /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 3 \
        --global-batch 2 --seq-len 4096

The port of the JAX package's ``repro.launch.train``, with its flags and
defaults (``--smoke`` is the default; ``--full`` trains the config at its
published widths), plus ``--device``: the CUDA card by default, ``cpu``
only when asked (the ALF algebra then runs its plain version). On the
card each residual branch is a MALI solve through the ALF kernels
(``--ode-backend auto``; ``pallas``, the JAX package's name, means
``cuda``). Killing a run and relaunching it with the same flags resumes
from the latest checkpoint and reproduces the uninterrupted loss trace;
relaunching with other integrator flags fails fast with
``ConfigMismatchError``. ``--production-mesh``, ``--multi-pod`` and
``--ode-batch-axis`` need data parallelism and are refused (ROADMAP
queue 1 item 9).
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ode", default="on", choices=["on", "off"])
    ap.add_argument("--ode-steps", type=int, default=2)
    ap.add_argument("--ode-method", default="mali",
                    choices=["mali", "naive", "aca", "adjoint"])
    ap.add_argument("--ode-backend", default="auto",
                    choices=["auto", "reference", "cuda", "pallas"])
    ap.add_argument("--ode-batch-axis", default="",
                    help="mesh axis for Sharded() solve batching ('' = off)")
    ap.add_argument("--loop", default="", help="TRAIN_LOOPS key "
                    "(default: standard, or compressed with --compress)")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-jsonl", default="",
                    help="write per-step StepRecord rows to this JSONL file")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="the config at its published widths")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="",
                    help="torch device ('' = the CUDA card; 'cpu')")
    a = ap.parse_args(argv)
    loop = a.loop or ("compressed" if a.compress else "standard")
    cfg = TrainerConfig(
        arch=a.arch, smoke=a.smoke, ode=a.ode == "on",
        ode_steps=a.ode_steps, ode_method=a.ode_method,
        ode_backend=a.ode_backend, ode_batch_axis=a.ode_batch_axis,
        steps=a.steps, global_batch=a.global_batch, seq_len=a.seq_len,
        microbatches=a.microbatches, loop=loop, ckpt_dir=a.ckpt_dir,
        ckpt_every=a.ckpt_every, keep=a.keep, seed=a.seed,
        log_every=a.log_every,
        emit="jsonl" if a.metrics_jsonl else "stdout",
        metrics_path=a.metrics_jsonl,
        production_mesh=a.production_mesh, multi_pod=a.multi_pod,
        device=a.device)
    final = Trainer(cfg).train()
    print(f"final_step={final}", flush=True)


if __name__ == "__main__":
    main()
