"""Serving entry point. LM path (default): batched prefill + greedy
autoregressive decode on the card::

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

Prefill runs eagerly. Decode goes through :func:`make_decode_step`, the
port's counterpart of the JAX package's jitted decode step: on the card
its first call runs one eager step and captures a CUDA graph of the next,
and every later step replays that graph; on the CPU each step runs
eagerly (the kernel ops take their plain versions there).

ODE path (``--mode ode``) — the ``repro_torch.serve`` serving loop::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode ode --batch 64 \
        --requests 256 --rate 100 [--ode-engine continuous|static] \
        [--chunk-steps 32] [--seed 0] [--d-state 32] [--t1 1.0] \
        [--rtol 1e-3 --atol 1e-4 --max-steps 512] [--device cpu]

Requests (each one initial state of a shared MLP vector field, with its
own stiffness scale) arrive as a Poisson stream (``--rate``; omit for
all-at-once) and are served by a :class:`repro_torch.serve.
ContinuousBatchingEngine` — ``--batch`` slots advanced in
``--chunk-steps`` chunked re-dispatch rounds, finished rows backfilled
from the queue between rounds. ``--ode-engine static`` runs the
no-backfill static-fleet baseline on the same stream. On the card the
chunk lane runs the per-row ALF kernels (``ALF(backend="cuda")``); on the
CPU their plain versions (``backend="reference"``). Prints the
:class:`repro_torch.serve.ServeReport`: p50/p99 latency, solves/s,
f-evals/request, occupancy.

Per-mode ``--batch`` defaults live in ``MODE_DEFAULT_BATCH`` (for ode,
batch == engine slots). ``--production-mesh`` (the JAX package's
multi-host GSPMD mesh) has no counterpart on one card and is refused.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.configs import (DEFAULT_ODE, ModelConfig, get_config,
                                 smoke_config)
from repro_torch.core.ode_block import OdeSettings
from repro_torch.device import resolve_device
from repro_torch.kernels import on_cuda
from repro_torch.models import decode_step, init_lm, moe, prefill
from repro_torch.models.lm import ServeState, init_serve_state

MODE_DEFAULT_BATCH = {"lm": 4, "ode": 64}

NO_PRODUCTION_MESH = (
    "--production-mesh is the JAX package's multi-host GSPMD mesh; the "
    "port serves on one card and has no counterpart")


def make_prefill_step(cfg):
    def prefill_step(params, batch, state: ServeState):
        return prefill(params, cfg, batch, state)
    return prefill_step


class DecodeGraph:
    """One CUDA graph of ``decode_step(..., backend="cuda")``, bound to one
    ``ServeState`` (its cache tensors and its ``pos`` tensor) and one
    params tree.

    The first call runs one eager step on a side stream (the warm-up a
    capture needs: it loads the kernels and makes cuBLAS's workspace for
    that stream) and returns its result, whose ``pos`` is a new tensor.
    It then captures, on the same stream and into the graph's own memory
    pool, the step that follows for the state it returns: the token is
    read from a static input, the cache is written at ``pos`` and ``pos``
    advances by one inside the graph. Every later call copies the token
    into the static input and replays the graph on the current stream; it
    returns a copy of the logits and the same state, its ``pos`` advanced
    in place.

    Raises on a call with another state's or another params' tensors or
    another token shape, on a capture while ``moe.recording_routes()`` is
    open (the graph would record the routes once, at capture), and on any
    capture or replay error. The kernel wrappers count their launches at
    the warm-up and at the capture; a replay calls no wrapper."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.graph = None

    @staticmethod
    def _bound(params, state: ServeState):
        return (tuple(t.data_ptr() for t in pytree.tree_leaves(state.cache)),
                tuple(t.data_ptr() for t in pytree.tree_leaves(params)))

    def __call__(self, params, tokens: torch.Tensor, state: ServeState):
        if self.graph is None:
            return self._warm_up_and_capture(params, tokens, state)
        if (state.pos is not self.pos
                or self._bound(params, state) != self.bound):
            raise ValueError("decode graph: called with another ServeState "
                             "or params than the ones it was captured for")
        if tokens.shape != self.tokens.shape:
            raise ValueError(f"decode graph: tokens of shape "
                             f"{tuple(tokens.shape)}, captured for "
                             f"{tuple(self.tokens.shape)}")
        self.tokens.copy_(tokens)
        self.graph.replay()
        return self.logits.clone(), state

    def _warm_up_and_capture(self, params, tokens, state):
        if moe.routes_recording():
            raise RuntimeError("decode graph: cannot capture while "
                               "moe.recording_routes() is open (the routes "
                               "would be recorded once, at capture)")
        current = torch.cuda.current_stream(tokens.device)
        side = torch.cuda.Stream(tokens.device)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            logits, state = decode_step(params, self.cfg, tokens, state)
            static_tokens = tokens.clone()
            graph.capture_begin()
            try:
                out, nxt = decode_step(params, self.cfg, static_tokens,
                                       state)
                state.pos.copy_(nxt.pos)
            finally:
                graph.capture_end()
        current.wait_stream(side)
        logits.record_stream(current)
        self.graph, self.tokens, self.logits = graph, static_tokens, out
        self.pos, self.bound = state.pos, self._bound(params, state)
        return logits, state


def make_decode_step(cfg):
    """The decode step ``serve`` runs, dispatched by the state's device: on
    the card a :class:`DecodeGraph` (captured at the first call, replayed
    after), on the CPU ``decode_step`` itself, eagerly."""
    graph = DecodeGraph(cfg)

    def serve_step(params, tokens, state: ServeState):
        if on_cuda("decode_step", state.pos.device):
            return graph(params, tokens, state)
        return decode_step(params, cfg, tokens, state)
    return serve_step


def serve_prompt(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device) -> dict:
    """The seeded random prompt ``serve`` prefills (its weights are
    ``init_lm`` from a generator seeded with the same ``seed``)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return {"embeds": torch.as_tensor(rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32),
            device=device)}
    return {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)), device=device)}


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

    params = init_lm(torch.Generator(device=dev).manual_seed(seed), cfg, dev)
    prompt = serve_prompt(cfg, batch, prompt_len, seed, dev)
    state = init_serve_state(cfg, batch, s_max, dev)
    prefill_fn = make_prefill_step(cfg)
    decode_fn = make_decode_step(cfg)

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


def mlp_field(rng: np.random.Generator, d_state: int, device=None):
    """The serving vector field: shared two-layer MLP with per-request
    stiffness in the state (``d scale/dt = 0``), its weights the JAX
    package's draws from ``rng``. ``f`` is written for one sample.
    Returns (f, params), the params on ``device`` (default: the card)."""
    dev = resolve_device(device)
    w1 = torch.as_tensor(rng.standard_normal((d_state, d_state)) * 0.4,
                         dtype=torch.float32, device=dev)
    w2 = torch.as_tensor(rng.standard_normal((d_state, d_state)) * 0.4,
                         dtype=torch.float32, device=dev)
    params = {"w1": w1, "w2": w2}

    def f(p, z, t):
        h = torch.tanh(z["y"] @ p["w1"])
        return {"y": z["scale"] * (h @ p["w2"] - z["y"]),
                "scale": torch.zeros_like(z["scale"])}

    return f, params


def ode_requests(rng: np.random.Generator, n_requests: int, d_state: int,
                 config, rate: float = 0.0):
    """The launcher's request stream, drawn after the field's weights:
    Poisson stamps at ``rate`` (0: all at t = 0), then per request a
    ``y ~ N(0, 1)^d`` and a stiffness ``scale = 10^U(0, 1)``."""
    from repro_torch.serve import Request, poisson_arrivals
    if rate > 0.0:
        arrivals = poisson_arrivals(rng, rate, n_requests)
    else:
        arrivals = np.zeros(n_requests)
    requests = []
    for i in range(n_requests):
        z0 = {"y": rng.standard_normal(d_state).astype(np.float32),
              "scale": np.full((d_state,),
                               10.0 ** rng.uniform(0.0, 1.0), np.float32)}
        requests.append(Request(z0=z0, config=config,
                                arrival=float(arrivals[i])))
    return requests


def serve_ode(*, batch: int = 64, d_state: int = 32, t1: float = 1.0,
              engine: str = "continuous", chunk_steps: int = 32,
              n_requests: int = 256, rate: float = 0.0, rtol: float = 1e-3,
              atol: float = 1e-4, max_steps: int = 512,
              production_mesh: bool = False, seed: int = 0, device=None):
    """Serve a stream of Neural-ODE solve requests through the
    ``repro_torch.serve`` engine stack.

    ``batch`` engine slots advance in ``chunk_steps``-trial dispatch
    rounds; ``engine='continuous'`` backfills retired rows from the queue
    between rounds, ``engine='static'`` runs the no-backfill fleet
    baseline. ``rate`` > 0 makes arrivals Poisson at that rate (requests/s
    of serving-clock time); 0 submits everything at t=0 (closed loop).
    Computes on ``device`` (default: the card; raises without one unless
    given ``device="cpu"``). Returns the run's
    :class:`repro_torch.serve.ServeReport`.
    """
    from repro_torch.core import ALF
    from repro_torch.serve import (ENGINES, EngineConfig, RequestConfig,
                                   format_report)

    if engine not in ENGINES:
        raise ValueError(f"unknown ode engine {engine!r}; "
                         f"choose from {sorted(ENGINES)}")
    if production_mesh:
        raise ValueError(NO_PRODUCTION_MESH)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    f, params = mlp_field(rng, d_state, dev)
    config = RequestConfig(t0=0.0, t1=t1, rtol=rtol, atol=atol,
                           max_steps=max_steps)
    requests = ode_requests(rng, n_requests, d_state, config, rate)

    print(f"ode serve: engine={engine} batch(slots)={batch} "
          f"chunk_steps={chunk_steps} d={d_state} t1={t1} "
          f"rtol={rtol} atol={atol} max_steps={max_steps} "
          f"requests={n_requests} "
          f"rate={rate if rate > 0 else 'all-at-once'} seed={seed} "
          f"device={dev}")

    backend = "cuda" if dev.type == "cuda" else "reference"
    eng = ENGINES[engine](
        f, params,
        config=EngineConfig(slots=batch, chunk_steps=chunk_steps,
                            solver=ALF(eta=0.9, backend=backend)),
        vf_id=f"mlp-d{d_state}-seed{seed}", device=dev)
    eng.submit(requests)
    report = eng.run()
    print(format_report(report))
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="lm", choices=["lm", "ode"],
                    help="lm: prefill/decode serving; ode: continuous-"
                         "batching ODE serving loop")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=None,
                    help="lm: requests per step; ode: engine batch slots "
                         f"(defaults: {MODE_DEFAULT_BATCH})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ode", default="on", choices=["on", "off"])
    ap.add_argument("--ode-engine", default="continuous",
                    choices=["continuous", "static"],
                    help="continuous: chunked backfill; static: one-shot "
                         "fleet baseline")
    ap.add_argument("--chunk-steps", type=int, default=32,
                    help="adaptive trials per dispatch round (ode)")
    ap.add_argument("--requests", type=int, default=256,
                    help="number of ODE requests to serve")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s "
                         "(0 = submit all at t=0)")
    ap.add_argument("--d-state", type=int, default=32,
                    help="ODE state dimension per request")
    ap.add_argument("--t1", type=float, default=1.0,
                    help="integration span end (ode)")
    ap.add_argument("--rtol", type=float, default=1e-3)
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--max-steps", type=int, default=512,
                    help="per-request adaptive trial budget (ode)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--production-mesh", action="store_true",
                    help="refused: no counterpart on one card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    if a.production_mesh:
        raise ValueError(NO_PRODUCTION_MESH)
    batch = MODE_DEFAULT_BATCH[a.mode] if a.batch is None else a.batch
    if a.mode == "ode":
        serve_ode(batch=batch, d_state=a.d_state, t1=a.t1,
                  engine=a.ode_engine, chunk_steps=a.chunk_steps,
                  n_requests=a.requests, rate=a.rate, rtol=a.rtol,
                  atol=a.atol, max_steps=a.max_steps, seed=a.seed,
                  device=a.device)
        return
    serve(a.arch, smoke=a.smoke, ode=a.ode == "on", prompt_len=a.prompt_len,
          decode_tokens=a.decode_tokens, batch=batch, seed=a.seed,
          device=a.device)


if __name__ == "__main__":
    main()
