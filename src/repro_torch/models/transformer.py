"""Block assembly, serve path: stacked periods x (mixer, mlp) residual
branches, with the paper's continuous-depth mode.

The port of the serve parts of the JAX package's
``repro.models.transformer``. Each residual branch is either the discrete
``x + f(norm(x))`` (``ode.mode == 'off'``) or the Neural-ODE
``x <- z(T), dz/dt = f_branch(z)`` integrated by ``ode.n_steps`` explicit
ALF steps (forward only), with the KV cache threaded through every f-eval:
each eval index is a cache "virtual layer" slot. The ALF state algebra
between the f-evals (``midpoint`` then ``update``, in float32) runs
through the fused ALF ops (``kernels/alf_step``), so the card launches the
ALF kernels inside every continuous-depth block.

Parameters and caches keep the JAX package's layout — the period's
parameters and caches stacked on a leading ``n_periods`` axis — so weights
convert leaf for leaf; the port loops over that axis in Python where the
JAX package scans. Caches are updated in place.

Only attention mixers and dense (or no) MLPs in the stacked period are
ported. The other layer kinds, and a prelude of unstacked layers (only
deepseek-moe-16b has one), raise ``NotImplementedError`` naming the ROADMAP
item they land with.
The training path (``layer_train``/``blocks_train``) comes with the
training slice.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.alf import check_backend
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.alf_step import ref as alf_ref

from .attention import (KVCache, attention_decode, attention_prefill,
                        init_attention)
from .common import rmsnorm, rmsnorm_init, torch_dtype
from .mlp import apply_mlp, init_mlp

Pytree = Any

# Layer kinds of the JAX package that land with a later slice.
_LATER = {
    "mamba": "the Jamba/SSM serving slice (ROADMAP queue 1)",
    "moe": "the Jamba/SSM serving slice, which ports models/moe.py "
           "(ROADMAP queue 1)",
    "mlstm": "the xLSTM slice (ROADMAP queue 1)",
    "slstm": "the xLSTM slice (ROADMAP queue 1)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config with a layer kind or a
    prelude this port does not have yet."""
    for spec in cfg.prelude + cfg.period:
        for kind in (spec.mixer, spec.mlp):
            if kind in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: {kind!r} layers are not ported yet; they "
                    f"land with {_LATER[kind]}")
    if cfg.prelude:
        raise NotImplementedError(
            f"{cfg.name}: prelude layers are not ported yet; they land with "
            f"{_LATER['moe']}")


def n_cache_slots(cfg: ModelConfig) -> int:
    """Virtual-layer count per block: v0-init + one per ALF step."""
    if cfg.ode.mode == "off":
        return 1
    return cfg.ode.n_steps + 1


def init_layer(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device) -> Pytree:
    dt = torch_dtype(cfg.param_dtype)
    params = {
        "mixer_norm": rmsnorm_init(cfg.d_model, dt, device),
        "mixer": init_attention(generator, cfg, device),
    }
    if spec.mlp == "dense":
        params["mlp_norm"] = rmsnorm_init(cfg.d_model, dt, device)
        params["mlp"] = init_mlp(generator, cfg, cfg.d_ff, device)
    return params


def init_blocks(generator: torch.Generator, cfg: ModelConfig,
                device) -> Pytree:
    check_supported(cfg)
    params: Pytree = {}
    if cfg.period:
        periods = [{f"sub{j}": init_layer(generator, cfg, spec, device)
                    for j, spec in enumerate(cfg.period)}
                   for _ in range(cfg.n_periods)]
        params["period"] = pytree.tree_map(lambda *xs: torch.stack(xs),
                                           *periods)
    return params


# ---------------------------------------------------------------------------
# Serve path (prefill / decode) — explicit ALF unroll with cache threading
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     s_max: int, device) -> KVCache:
    return KVCache.init(cfg, n_cache_slots(cfg), batch, s_max, device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> Pytree:
    check_supported(cfg)
    cache: Pytree = {}
    if cfg.period:
        slots = n_cache_slots(cfg)
        dt = torch_dtype(cfg.compute_dtype)
        shape = (cfg.n_periods, slots, batch, s_max, cfg.n_kv_heads,
                 cfg.d_head)
        cache["period"] = {
            f"sub{j}": KVCache(torch.zeros(shape, dtype=dt, device=device),
                               torch.zeros(shape, dtype=dt, device=device))
            for j in range(len(cfg.period))}
    return cache


def _mixer_serve(params, cfg, spec, z, cache, slot, pos_info, kind,
                 backend):
    """Dispatch one mixer f-eval with cache read/write at `slot`."""
    if kind == "prefill":
        return attention_prefill(params, cfg, spec, z, pos_info, cache, slot,
                                 backend)
    return attention_decode(params, cfg, spec, z, pos_info, cache, slot,
                            backend)


def _alf_unroll(f, x: torch.Tensor, n: int, eta: float, h: torch.Tensor,
                backend: str) -> torch.Tensor:
    """``n`` explicit ALF steps of dz/dt = f(z, i) from z = x (f32 state,
    v0 = f(x, 0)); f's second argument is the f-eval index. The state
    algebra is the fused ALF ops (kernels on the card) or, with
    ``backend="reference"``, their plain versions."""
    v = f(x, 0)
    z = x.float()
    for i in range(n):
        if backend == "cuda":
            k1 = alf_ops.alf_midpoint(z, v, h)
            z, v = alf_ops.alf_update(k1, v, f(k1, i + 1), h, eta=eta)
        else:
            k1 = alf_ref.midpoint_ref(z, v, h)
            z, v = alf_ref.update_ref(k1, v, f(k1, i + 1), h, eta)
    return z.to(x.dtype)


def layer_serve(params: Pytree, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, cache: KVCache, pos_info, kind: str,
                backend: str = "cuda") -> Tuple[torch.Tensor, KVCache]:
    """One layer, serve mode. pos_info: positions [B,S] (prefill) or int
    pos (decode). The cache is written in place and returned."""
    check_backend(backend)
    ode = cfg.ode
    cdt = torch_dtype(cfg.compute_dtype)

    def mixer_eval(z, slot):
        zn = rmsnorm(params["mixer_norm"], z.to(cdt), backend=backend)
        y, _ = _mixer_serve(params["mixer"], cfg, spec, zn, cache, slot,
                            pos_info, kind, backend)      # cache in place
        return y.float()

    def mlp_eval(z, _slot=None):
        zn = rmsnorm(params["mlp_norm"], z.to(cdt), backend=backend)
        return apply_mlp(params["mlp"], zn).float()

    if ode.mode == "off":
        x = x + mixer_eval(x, 0).to(x.dtype)
        if spec.mlp != "none":
            x = x + mlp_eval(x).to(x.dtype)
        return x, cache

    n, eta = ode.n_steps, ode.eta
    # the step size as a 0-d f32 tensor on the card, made by a fill
    # kernel (no host-to-device copy, no sync)
    h = torch.full((), ode.t1 / n, dtype=torch.float32, device=x.device)
    x = _alf_unroll(mixer_eval, x, n, eta, h, backend)
    if spec.mlp != "none":
        x = _alf_unroll(mlp_eval, x, n, eta, h, backend)
    return x, cache


def blocks_serve(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                 cache: Pytree, pos_info, kind: str, backend: str = "cuda"
                 ) -> Tuple[torch.Tensor, Pytree]:
    for p in range(cfg.n_periods if cfg.period else 0):
        pp = pytree.tree_map(lambda a: a[p], params["period"])
        cc = pytree.tree_map(lambda a: a[p], cache["period"])   # views
        for j, spec in enumerate(cfg.period):
            x, _ = layer_serve(pp[f"sub{j}"], cfg, spec, x, cc[f"sub{j}"],
                               pos_info, kind, backend)
    return x, cache
