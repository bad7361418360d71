"""Block assembly, serve path: (prelude, stacked periods) x (mixer, mlp)
residual branches, with the paper's continuous-depth mode.

The port of the serve parts of the JAX package's
``repro.models.transformer``. Each residual branch is either the discrete
``x + f(norm(x))`` (``ode.mode == 'off'``) or the Neural-ODE
``x <- z(T), dz/dt = f_branch(z)`` integrated by ``ode.n_steps`` explicit
ALF steps (forward only), with the KV or SSM cache threaded through every
f-eval: each eval index is a cache "virtual layer" slot. The ALF state
algebra between the f-evals (``midpoint`` then ``update``, in float32)
runs through the fused ALF ops (``kernels/alf_step``), so the card
launches the ALF kernels inside every continuous-depth block.

Mixers: attention (``attention.py``) and Mamba (``ssm.py``); MLPs: dense
(``mlp.py``), MoE (``moe.py``, at the serve-time capacity) or none.
Parameters and caches keep the JAX package's layout — the prelude's
layers unstacked in a list, the period's parameters and caches stacked on
a leading ``n_periods`` axis — so weights convert leaf for leaf; the port
loops over that axis in Python where the JAX package scans. Caches are
updated in place.

The xLSTM mixers raise ``NotImplementedError`` naming the ROADMAP item
they land with. The training path (``layer_train``/``blocks_train``)
comes with the training slice.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.alf import check_backend
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.alf_step import ref as alf_ref

from .attention import (KVCache, attention_decode, attention_inits,
                        attention_prefill)
from .common import materialize, rmsnorm, rmsnorm_inits, torch_dtype
from .mlp import apply_mlp, mlp_inits
from .moe import apply_moe, moe_inits
from .ssm import (MambaCache, apply_mamba_decode, apply_mamba_prefill,
                  mamba_inits)

Pytree = Any

# Layer kinds of the JAX package that land with a later slice.
_LATER = {
    "mlstm": "the xLSTM slice (ROADMAP queue 1)",
    "slstm": "the xLSTM slice (ROADMAP queue 1)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config with a layer kind this
    port does not have yet."""
    for spec in cfg.prelude + cfg.period:
        for kind in (spec.mixer, spec.mlp):
            if kind in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: {kind!r} layers are not ported yet; they "
                    f"land with {_LATER[kind]}")


def n_cache_slots(cfg: ModelConfig) -> int:
    """Virtual-layer count per block: v0-init + one per ALF step."""
    if cfg.ode.mode == "off":
        return 1
    return cfg.ode.n_steps + 1


_MIXER_INITS = {
    "attn": attention_inits,
    "mamba": mamba_inits,
}


def layer_inits(generator: torch.Generator, cfg: ModelConfig,
                spec: LayerSpec, device,
                dense_d_ff: Optional[int] = None) -> Pytree:
    """Leaf initializers (``common.materialize``) of one layer."""
    dt = torch_dtype(cfg.param_dtype)
    params = {
        "mixer_norm": rmsnorm_inits(cfg.d_model, dt, device),
        "mixer": _MIXER_INITS[spec.mixer](generator, cfg, device),
    }
    if spec.mlp == "dense":
        params["mlp_norm"] = rmsnorm_inits(cfg.d_model, dt, device)
        params["mlp"] = mlp_inits(generator, cfg, dense_d_ff or cfg.d_ff,
                                  device)
    elif spec.mlp == "moe":
        params["mlp_norm"] = rmsnorm_inits(cfg.d_model, dt, device)
        params["mlp"] = moe_inits(generator, cfg, device)
    return params


def init_layer(generator: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               device, dense_d_ff: Optional[int] = None) -> Pytree:
    return materialize(layer_inits(generator, cfg, spec, device, dense_d_ff))


def init_blocks(generator: torch.Generator, cfg: ModelConfig,
                device) -> Pytree:
    """The prelude's layers, then the period's, each leaf allocated once
    as [n_periods, ...] and filled period by period as it is drawn: init
    holds the weights plus one leaf's draw temporaries (stacking finished
    periods would hold the weights twice)."""
    check_supported(cfg)
    params: Pytree = {}
    if cfg.prelude:
        params["prelude"] = [
            init_layer(generator, cfg, spec, device,
                       dense_d_ff=cfg.prelude_d_ff or None)
            for spec in cfg.prelude]
    if cfg.period:
        stacked, tree = None, None
        for p in range(cfg.n_periods):
            inits, tree = pytree.tree_flatten(
                {f"sub{j}": layer_inits(generator, cfg, spec, device)
                 for j, spec in enumerate(cfg.period)})
            if stacked is None:
                stacked = [None] * len(inits)
            for i, make in enumerate(inits):
                leaf = make()
                if stacked[i] is None:
                    stacked[i] = leaf.new_empty((cfg.n_periods, *leaf.shape))
                stacked[i][p].copy_(leaf)
                del leaf
        params["period"] = pytree.tree_unflatten(stacked, tree)
    return params


# ---------------------------------------------------------------------------
# Serve path (prefill / decode) — explicit ALF unroll with cache threading
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     s_max: int, device) -> Pytree:
    slots = n_cache_slots(cfg)
    if spec.mixer == "attn":
        return KVCache.init(cfg, slots, batch, s_max, device)
    return MambaCache.init(cfg, slots, batch, device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> Pytree:
    check_supported(cfg)
    cache: Pytree = {}
    if cfg.prelude:
        cache["prelude"] = [init_layer_cache(cfg, spec, batch, s_max, device)
                            for spec in cfg.prelude]
    if cfg.period:
        proto = {f"sub{j}": init_layer_cache(cfg, spec, batch, s_max, device)
                 for j, spec in enumerate(cfg.period)}
        # tiled from one period's caches (not zeros), as the JAX package
        # does, so a non-zero initial state would carry over
        cache["period"] = pytree.tree_map(
            lambda t: t[None].repeat(cfg.n_periods, *(1,) * t.dim()), proto)
    return cache


def _mixer_serve(params, cfg, spec, z, cache, slot, pos_info, kind,
                 backend):
    """Dispatch one mixer f-eval with cache read/write at `slot`."""
    if spec.mixer == "attn":
        if kind == "prefill":
            return attention_prefill(params, cfg, spec, z, pos_info, cache,
                                     slot, backend)
        return attention_decode(params, cfg, spec, z, pos_info, cache, slot,
                                backend)
    if kind == "prefill":
        y, (conv_state, ssm_state) = apply_mamba_prefill(
            params, cfg, z, return_state=True, backend=backend)
        cache.conv[slot] = conv_state
        cache.ssm[slot] = ssm_state
        return y, cache
    return apply_mamba_decode(params, cfg, z, cache, slot)


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
                x: torch.Tensor, cache: Pytree, pos_info, kind: str,
                backend: str = "cuda") -> Tuple[torch.Tensor, Pytree]:
    """One layer, serve mode. pos_info: positions [B,S] (prefill) or the
    0-d int32 pos tensor (decode). The cache is written in place and
    returned."""
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
        if spec.mlp == "moe":
            return apply_moe(params["mlp"], cfg, zn, eval_mode=True).float()
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
    for i, spec in enumerate(cfg.prelude):
        x, _ = layer_serve(params["prelude"][i], cfg, spec, x,
                           cache["prelude"][i], pos_info, kind, backend)
    for p in range(cfg.n_periods if cfg.period else 0):
        pp = pytree.tree_map(lambda a: a[p], params["period"])
        cc = pytree.tree_map(lambda a: a[p], cache["period"])   # views
        for j, spec in enumerate(cfg.period):
            x, _ = layer_serve(pp[f"sub{j}"], cfg, spec, x, cc[f"sub{j}"],
                               pos_info, kind, backend)
    return x, cache
