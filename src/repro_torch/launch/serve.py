"""Serving entry point, LM path: batched prefill + greedy autoregressive decode
on the card::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --prompt-len 32 --decode-tokens 16 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --full --prompt-len 1024 --decode-tokens 32 --batch 4

The port of the JAX package's ``repro.launch.serve`` LM path. ``--smoke``
(the default) runs the reduced same-family config, ``--full`` the real one
at its published widths. Weights are seeded random (``--seed``); the prompt
is seeded random tokens. Prints per-phase timings and tokens/s. The device
defaults to the CUDA card (``--device cpu`` runs the plain versions of the
kernels on the CPU).

The ODE serving loop (``--mode ode``) lands with the serving-engine slice
(ROADMAP queue 1 (c)) and raises ``NotImplementedError`` here.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.configs import (DEFAULT_ODE, ModelConfig, get_config,
                                 smoke_config)
from repro_torch.core.ode_block import OdeSettings
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_lm, prefill
from repro_torch.models.lm import ServeState, init_serve_state

MODE_DEFAULT_BATCH = {"lm": 4, "ode": 64}


def make_prefill_step(cfg):
    def prefill_step(params, batch, state: ServeState):
        return prefill(params, cfg, batch, state)
    return prefill_step


def make_decode_step(cfg):
    def serve_step(params, tokens, state: ServeState):
        return decode_step(params, cfg, tokens, state)
    return serve_step


class ServeResult(NamedTuple):
    tokens: np.ndarray     # [batch, decode_tokens] greedy tokens
    prefill_ms: float      # host clock, ends in a device sync
    decode_ms: float       # all decode steps, ends in a device sync
    prefill_tok_s: float
    decode_tok_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: Union[str, ModelConfig], *, smoke: bool = True,
          ode: bool = True, prompt_len: int = 32, decode_tokens: int = 16,
          batch: int = 4, seed: int = 0, device=None) -> ServeResult:
    """Prefill a seeded random prompt, then decode greedily; returns the
    tokens and the timings. ``arch`` is an arch name (its smoke or full
    config, per ``smoke``) or a ``ModelConfig`` served as given (a depth
    cut, say; ``smoke`` is then not read)."""
    settings = DEFAULT_ODE if ode else OdeSettings(mode="off")
    if isinstance(arch, ModelConfig):
        cfg = arch.with_ode(settings).validate()
    elif smoke:
        cfg = smoke_config(arch, settings)
    else:
        cfg = get_config(arch, settings)
    dev = resolve_device(device)
    s_max = prompt_len + decode_tokens
    rng = np.random.default_rng(seed)

    params = init_lm(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
    state = init_serve_state(cfg, batch, s_max, dev)
    prefill_fn = make_prefill_step(cfg)
    decode_fn = make_decode_step(cfg)

    if cfg.input_mode == "embeds":
        prompt = {"embeds": torch.as_tensor(rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32), device=dev)}
    else:
        prompt = {"tokens": torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (batch, prompt_len)), device=dev)}

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill_fn(params, prompt, state)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    t0 = time.perf_counter()
    for _ in range(decode_tokens):
        if cfg.input_mode == "embeds":
            # stub frontend: feed the token id through a fixed projection
            inp = tok[..., None].float().expand(-1, -1, cfg.d_model) * 1e-3
        else:
            inp = tok
        logits, state = decode_fn(params, inp, state)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out_tokens.append(tok[:, 0])
    _sync(dev)
    t_decode = time.perf_counter() - t0

    toks = torch.stack(out_tokens, 1).cpu().numpy()
    result = ServeResult(
        tokens=toks, prefill_ms=t_prefill * 1e3, decode_ms=t_decode * 1e3,
        prefill_tok_s=batch * prompt_len / max(t_prefill, 1e-9),
        decode_tok_s=batch * decode_tokens / max(t_decode, 1e-9))
    print(f"arch={cfg.name} batch={batch} prompt={prompt_len} "
          f"decode={decode_tokens} device={dev}")
    print(f"prefill: {result.prefill_ms:.1f} ms "
          f"({result.prefill_tok_s:.0f} tok/s)")
    print(f"decode:  {result.decode_ms:.1f} ms "
          f"({result.decode_tok_s:.0f} tok/s)")
    print("sample:", toks[0][:12].tolist())
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="lm", choices=["lm", "ode"],
                    help="lm: prefill/decode serving; ode: the ODE serving "
                         "loop (not ported yet)")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=None,
                    help=f"requests per step (defaults: {MODE_DEFAULT_BATCH})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ode", default="on", choices=["on", "off"])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    if a.mode == "ode":
        raise NotImplementedError(
            "--mode ode (the continuous-batching ODE serving loop) is not "
            "ported yet: it lands with the serving-engine slice, ROADMAP "
            "queue 1 (c)")
    batch = MODE_DEFAULT_BATCH[a.mode] if a.batch is None else a.batch
    serve(a.arch, smoke=a.smoke, ode=a.ode == "on", prompt_len=a.prompt_len,
          decode_tokens=a.decode_tokens, batch=batch, seed=a.seed,
          device=a.device)


if __name__ == "__main__":
    main()
