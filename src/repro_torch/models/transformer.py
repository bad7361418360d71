"""Block assembly: (prelude, stacked periods) x (mixer, mlp) residual
branches, with the paper's continuous-depth mode.

The port of the JAX package's ``repro.models.transformer``.

Train path (``layer_train``/``blocks_train``): each residual branch is
either the discrete ``x + f(norm(x))`` (``ode.mode == 'off'``, the
"ResNet" baseline of paper Sec 4.2) or the Neural ODE
``x <- z(T), dz/dt = f_branch(z)`` integrated by ``solve()`` with the
configured solver, controller and gradient method (MALI by default) —
paper Sec 4.2's ResNet->Neural-ODE conversion applied per residual
branch, parameter count unchanged. With ``ALF(backend="cuda")`` the
state algebra launches the ALF kernels (forward: midpoint + update per
step; MALI's backward: bwd_pre + bwd_post per step); the branch's own
f (attention, Mamba, MLP, MoE, the norms) runs plain PyTorch, as the JAX
package trains through the plain versions of its LM kernels. In a
training step over a mesh each layer is where FSDP gathers the leaves
that the rule splits over 'data' (:func:`~repro_torch.distributed.
data_parallel.fsdp_gathered`, once for the layer's forward and once for
its backward), and its mixer and MLP compute on their blocks of the
leaves split over 'model' (:mod:`repro_torch.distributed.
tensor_parallel`); the ODE state between them is whole on every rank.

Serve path (prefill/decode): forward only, so the ALF steps are unrolled
explicitly with the KV or SSM cache threaded through every f-eval: each
eval index is a cache "virtual layer" slot. In a serve step on a mesh
the layers gather their 'data' shards once each and compute over
'model' as in training, on the rank's blocks of the caches; the state
between the branches stays whole and bit-equal on a 'model' group. The
ALF state algebra between the f-evals (``midpoint`` then ``update``, in float32) runs through the
fused ALF ops (``kernels/alf_step``), so the card launches the ALF
kernels inside every continuous-depth block.

Mixers: attention (``attention.py``), Mamba (``ssm.py``) and the xLSTM
mixers mLSTM and sLSTM (``xlstm.py``); MLPs: dense
(``mlp.py``), MoE (``moe.py``: the training capacity on the train path,
the serve-time one on the serve path) or none. Parameters and caches keep
the JAX package's layout — the prelude's layers unstacked in a list, the
period's parameters and caches stacked on a leading ``n_periods`` axis —
so weights convert leaf for leaf; the port loops over that axis in Python
where the JAX package scans. Caches are updated in place.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch import tree_util
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.alf import check_backend
from repro_torch.core.interface import RunStats
from repro_torch.core.solve import solve
from repro_torch.distributed.data_parallel import fsdp_gathered, fsdp_unbind
from repro_torch.distributed.sharding import _path_names
from repro_torch.distributed.tensor_parallel import record_state
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.alf_step import ref as alf_ref

from .attention import (KVCache, attention_decode, attention_inits,
                        attention_prefill, attention_train)
from .common import materialize, rmsnorm, rmsnorm_inits, torch_dtype
from .mlp import apply_mlp, mlp_inits
from .moe import apply_moe, moe_inits
from .ssm import (MambaCache, apply_mamba_decode, apply_mamba_prefill,
                  apply_mamba_train, mamba_inits)
from .xlstm import (LstmCache, apply_mlstm_decode, apply_mlstm_train,
                    apply_slstm_decode, apply_slstm_train, mlstm_inits,
                    slstm_inits)

Pytree = Any

def n_cache_slots(cfg: ModelConfig) -> int:
    """Virtual-layer count per block: v0-init + one per ALF step."""
    if cfg.ode.mode == "off":
        return 1
    return cfg.ode.n_steps + 1


_MIXER_INITS = {
    "attn": attention_inits,
    "mamba": mamba_inits,
    "mlstm": mlstm_inits,
    "slstm": slstm_inits,
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
                device, cut=None) -> Pytree:
    """The prelude's layers, then the period's, each leaf allocated once
    as [n_periods, ...] and filled period by period as it is drawn: init
    holds the weights plus one leaf's draw temporaries (stacking finished
    periods would hold the weights twice). ``cut(names, leaf, period)``
    (a serve plan's ``cut``) keeps a rank's block of each leaf as it is
    drawn (``names`` its key path; ``period``: one period of a stacked
    leaf), so init holds the rank's blocks plus one whole leaf."""
    params: Pytree = {}
    if cfg.prelude:
        params["prelude"] = []
        for i, spec in enumerate(cfg.prelude):
            inits = layer_inits(generator, cfg, spec, device,
                                dense_d_ff=cfg.prelude_d_ff or None)
            params["prelude"].append(
                materialize(inits) if cut is None else
                pytree.tree_map_with_path(
                    lambda path, make: cut(
                        ("blocks", "prelude", str(i)) + _path_names(path),
                        make()),
                    inits))
    if cfg.period:
        stacked, tree = None, None
        for p in range(cfg.n_periods):
            inits, tree = pytree.tree_flatten_with_path(
                {f"sub{j}": layer_inits(generator, cfg, spec, device)
                 for j, spec in enumerate(cfg.period)})
            if stacked is None:
                stacked = [None] * len(inits)
            for i, (path, make) in enumerate(inits):
                leaf = make()
                if cut is not None:
                    leaf = cut(("blocks", "period") + _path_names(path),
                               leaf, True)
                if stacked[i] is None:
                    stacked[i] = leaf.new_empty((cfg.n_periods, *leaf.shape))
                stacked[i][p].copy_(leaf)
                del leaf
        params["period"] = pytree.tree_unflatten(stacked, tree)
    return params


# ---------------------------------------------------------------------------
# Train path
# ---------------------------------------------------------------------------

# the token-recurrent mixers' train paths, each apply(params, cfg, x)
_RECURRENT_TRAIN = {
    "mamba": apply_mamba_train,
    "mlstm": apply_mlstm_train,
    "slstm": apply_slstm_train,
}


def _mixer_train_fn(cfg: ModelConfig, spec: LayerSpec, positions=None):
    # positions stay None on the ODE path: attention makes its own 0..S-1
    # (and then skips the tiles its causal mask hides)
    if spec.mixer == "attn":
        return lambda p, z: attention_train(p, cfg, spec, z, positions)
    apply = _RECURRENT_TRAIN[spec.mixer]
    return lambda p, z: apply(p, cfg, z)


def _mlp_train_fn(cfg: ModelConfig, spec: LayerSpec,
                  eval_mode: bool = False, d_ff: Optional[int] = None):
    """The MLP branch's f; ``d_ff`` is a dense MLP's hidden width (the
    prelude's may differ from ``cfg.d_ff``)."""
    if spec.mlp == "moe":
        return lambda p, z: apply_moe(p, cfg, z, eval_mode=eval_mode)
    d_ff = d_ff or cfg.d_ff
    return lambda p, z: apply_mlp(p, z, d_ff)


def zero_run_stats(device) -> RunStats:
    """Zero int32 counters on ``device`` (a fill kernel: no host copy)."""
    z = torch.zeros((), dtype=torch.int32, device=device)
    return RunStats(z, z, z)


# The JAX package launders each solve's counters (``_detach_counter``)
# because a custom_vjp's integer outputs carry float0 tangents under a
# jvp trace. The port's counters are integer outputs of an
# autograd.Function, which autograd never differentiates: they are plain
# tensors and need no counterpart.


def add_run_stats(a: RunStats, b: RunStats) -> RunStats:
    return RunStats(a.n_accepted + b.n_accepted,
                    a.n_rejected + b.n_rejected,
                    a.n_fevals + b.n_fevals)


def _residual_branch(cfg: ModelConfig, branch_params: Pytree,
                     x: torch.Tensor, inner) -> Tuple[torch.Tensor, RunStats]:
    """Apply one residual branch discretely or as a Neural ODE.

    The ODE state (z, v) is kept in float32 — ALF's exact reversibility
    is a float-rounding property, and a bf16 state would visibly degrade
    the backward reconstruction; ``f`` itself computes in the model's
    compute dtype (cast at the norm boundary), with the plain RMSNorm.
    Returns the branch output and the solve's :class:`RunStats` (int32
    counters on x's device)."""
    cdt = torch_dtype(cfg.compute_dtype)

    def dynamics(p, z, t):
        zn = rmsnorm(p["norm"], z.to(cdt), backend="reference")
        return inner(p["inner"], zn).float()

    p = {"norm": branch_params["norm"], "inner": branch_params["inner"]}
    ode = cfg.ode
    if ode.mode == "off":
        zn = rmsnorm(p["norm"], x, backend="reference")
        return x + inner(p["inner"], zn), zero_run_stats(x.device)
    solver, controller, gradient, saveat = ode.as_objects()
    sol = solve(dynamics, p, x.float(), 0.0, ode.t1, solver=solver,
                controller=controller, gradient=gradient, saveat=saveat,
                batching=ode.batching())
    stats = RunStats(sol.stats.n_accepted, sol.stats.n_rejected,
                     sol.stats.n_fevals)
    record_state(sol.ys)
    return sol.ys.to(x.dtype), stats


def layer_train(params: Pytree, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, positions=None,
                dense_d_ff: Optional[int] = None
                ) -> Tuple[torch.Tensor, RunStats]:
    """One layer's two residual branches (mixer, then the MLP unless
    ``spec.mlp == 'none'``) and their summed counters. In a training step
    over a mesh, the layer's leaves split over 'data' are gathered for
    its forward here (and, where autograd saved them, once more for its
    backward)."""
    with fsdp_gathered(params) as params:
        x, stats = _residual_branch(
            cfg, {"norm": params["mixer_norm"], "inner": params["mixer"]},
            x, _mixer_train_fn(cfg, spec, None))
        if spec.mlp != "none":
            x, s2 = _residual_branch(
                cfg, {"norm": params["mlp_norm"], "inner": params["mlp"]}, x,
                _mlp_train_fn(cfg, spec, d_ff=dense_d_ff))
            stats = add_run_stats(stats, s2)
    return x, stats


def _periods(stacked: Pytree, n: int):
    """The ``n`` periods of a stacked parameter tree, as views: each leaf
    unbound once, so the backward stacks the periods' gradients in one
    op (an index per period would add a stack-sized zero tensor per
    period)."""
    leaves, spec = tree_util.tree_flatten(stacked)
    parts = [fsdp_unbind(leaf) for leaf in leaves]
    return [tree_util.tree_unflatten([part[p] for part in parts], spec)
            for p in range(n)]


def blocks_train(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                 positions=None) -> Tuple[torch.Tensor, RunStats]:
    """Returns (activations, summed ODE RunStats over every residual
    branch)."""
    stats = zero_run_stats(x.device)
    for i, spec in enumerate(cfg.prelude):
        x, s = layer_train(params["prelude"][i], cfg, spec, x, positions,
                           dense_d_ff=cfg.prelude_d_ff or None)
        stats = add_run_stats(stats, s)
    if cfg.period:
        for pp in _periods(params["period"], cfg.n_periods):
            for j, spec in enumerate(cfg.period):
                x, s = layer_train(pp[f"sub{j}"], cfg, spec, x, positions)
                stats = add_run_stats(stats, s)
    return x, stats


# ---------------------------------------------------------------------------
# Serve path (prefill / decode) — explicit ALF unroll with cache threading
# ---------------------------------------------------------------------------

def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     s_max: int, device, cut=None) -> Pytree:
    """One layer's cache; ``cut(field, shape)`` (a serve plan's
    ``cache_shape``) makes each leaf the rank's block."""
    slots = n_cache_slots(cfg)
    if spec.mixer == "attn":
        return KVCache.init(cfg, slots, batch, s_max, device, cut)
    if spec.mixer == "mamba":
        return MambaCache.init(cfg, slots, batch, device, cut)
    if spec.mixer == "mlstm":
        return LstmCache.init_mlstm(cfg, slots, batch, device, cut)
    return LstmCache.init_slstm(cfg, slots, batch, device, cut)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device,
               cut=None) -> Pytree:
    """The serve cache of a global ``batch`` (with ``cut``, the rank's
    blocks of it: :func:`init_layer_cache`)."""
    cache: Pytree = {}
    if cfg.prelude:
        cache["prelude"] = [init_layer_cache(cfg, spec, batch, s_max, device,
                                             cut)
                            for spec in cfg.prelude]
    if cfg.period:
        proto = {f"sub{j}": init_layer_cache(cfg, spec, batch, s_max, device,
                                             cut)
                 for j, spec in enumerate(cfg.period)}
        # tiled from one period's caches (not zeros), as the JAX package
        # does, so the xLSTM stabilizer's -1e30 start carries over (a
        # broadcast copy: a meta repeat would import sympy)
        cache["period"] = pytree.tree_map(
            lambda t: t.new_empty((cfg.n_periods, *t.shape)).copy_(t[None]),
            proto)
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
    if spec.mixer == "mamba":
        if kind == "prefill":
            y, (conv_state, ssm_state) = apply_mamba_prefill(
                params, cfg, z, return_state=True, backend=backend)
            cache.conv[slot] = conv_state
            cache.ssm[slot] = ssm_state
            return y, cache
        return apply_mamba_decode(params, cfg, z, cache, slot)
    mlstm = spec.mixer == "mlstm"
    if kind == "prefill":
        apply = apply_mlstm_train if mlstm else apply_slstm_train
        y, carry = apply(params, cfg, z, return_state=True)
        # mLSTM: (C, n, m), its cache's h unused; sLSTM: (c, n, m, h)
        for buf, val in zip(cache, carry):
            buf[slot] = val
        return y, cache
    decode = apply_mlstm_decode if mlstm else apply_slstm_decode
    return decode(params, cfg, z, cache, slot)


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
    record_state(z)
    return z.to(x.dtype)


def layer_serve(params: Pytree, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, cache: Pytree, pos_info, kind: str,
                backend: str = "cuda", dense_d_ff: Optional[int] = None
                ) -> Tuple[torch.Tensor, Pytree]:
    """One layer, serve mode. pos_info: positions [B,S] (prefill) or the
    0-d int32 pos tensor (decode). The cache is written in place and
    returned. ``dense_d_ff``: a dense MLP's hidden width where it is not
    ``cfg.d_ff`` (the prelude's), which the split over 'model' reads."""
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
        return apply_mlp(params["mlp"], zn, dense_d_ff or cfg.d_ff).float()

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
    """Every layer, serve mode. In a serve step on a mesh each layer's
    leaves split over 'data' are gathered once, for its f-evals, and
    freed after it (FSDP)."""
    for i, spec in enumerate(cfg.prelude):
        with fsdp_gathered(params["prelude"][i]) as lp:
            x, _ = layer_serve(lp, cfg, spec, x, cache["prelude"][i],
                               pos_info, kind, backend,
                               dense_d_ff=cfg.prelude_d_ff or None)
    if cfg.period:
        for p, pp in enumerate(_periods(params["period"], cfg.n_periods)):
            cc = pytree.tree_map(lambda a: a[p], cache["period"])   # views
            for j, spec in enumerate(cfg.period):
                with fsdp_gathered(pp[f"sub{j}"]) as lp:
                    x, _ = layer_serve(lp, cfg, spec, x, cc[f"sub{j}"],
                                       pos_info, kind, backend)
    return x, cache
