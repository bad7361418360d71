"""Mamba (selective SSM) mixer — the Jamba hybrid's dominant layer type.

The port of the JAX package's ``repro.models.ssm``:

  * ``apply_mamba_train`` — the training path: the chunked selective
    scan in plain PyTorch, differentiable by autograd, as in the JAX
    package (the scan kernel is forward-only in both packages). The
    sequence runs in chunks of ``_CHUNK`` carrying the state h; inside a
    chunk an associative scan over the discretised terms (dA, dBu)
    gives every h_t in log2(chunk) doubling steps. The JAX package wraps
    each chunk in ``jax.checkpoint``; the port does not:
    ``torch.utils.checkpoint`` refuses ``torch.func`` transforms, and
    MALI's backward runs this mixer under ``torch.func.vjp`` (there one
    backward step holds one f-eval's internals anyway).

  * ``apply_mamba_prefill`` — the whole prompt: in-projection, depthwise
    causal conv, the discretisation inputs (delta, A = -exp(A_log), B, C)
    and the recurrence through the selective-scan op (the hand-written
    kernel on the card, its plain version on the CPU or with
    ``backend="reference"``), then the skip ``D * u``, the ``silu(res)``
    gate and the out-projection. The JAX package's train/prefill path
    (``apply_mamba_train``) materialises ``dA`` and ``dBu`` ([B, S, DI,
    ST] float32) and runs an associative scan over them; the scan op
    computes the same recurrence sequentially from the factors, so neither
    tensor is ever formed.
  * ``apply_mamba_decode`` — the O(1) recurrent update of one token against
    the (conv, ssm) state cache, as in the JAX package.

Under tensor parallelism over 'model' (a training step on a mesh,
:func:`~repro_torch.distributed.tensor_parallel.model_split`), where the
JAX package's ``hint`` calls pin the scan's d_inner over 'model', each rank
runs its block of d_inner: ``in_proj``'s column blocks are gathered and
each rank takes its block of ``u`` and of the gate (the rule splits the
fused ``[u | gate]`` columns in contiguous blocks); ``conv_w``,
``dt_proj``, ``A_log`` and the per-channel vectors are the rank's block;
``x_proj``'s contraction over d_inner is summed over the group, and
``out_proj`` is row-parallel, its partial outputs summed. A serve step on
a mesh whose caches split d_inner over 'model' (``ServePlan.computing``)
runs the same split without autograd on its block of the conv and ssm
caches, the scan kernel on the local d_inner; the whole leaves it cuts
to its block include every leaf of a config whose weights the rule
replicates.

Caches are written in place (the JAX package returns updated copies);
each function still returns the cache it was given.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.alf import check_backend
from repro_torch.distributed.tensor_parallel import (block, enter,
                                                     enter_leaves,
                                                     gather_dim,
                                                     gather_last_summed,
                                                     leave, model_split,
                                                     serve_model, splits,
                                                     sum_over)
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

from .common import dense_inits, full_inits, silu, torch_dtype

Pytree = Any

_CHUNK = 4096


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def mamba_inits(generator: torch.Generator, cfg: ModelConfig,
                device) -> Pytree:
    """Leaf initializers (``common.materialize``) of one Mamba mixer."""
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    d = cfg.d_model

    def a_log():
        if torch.device(device).type == "meta":
            # a shape only (meta arange and log import torch._dynamo)
            return torch.empty((d_inner, d_state), dtype=f32, device=device)
        a = torch.arange(1, d_state + 1, dtype=f32, device=device)
        return torch.log(a[None, :].repeat(d_inner, 1))

    return {
        "in_proj": dense_inits(generator, (d, 2 * d_inner), dt, device),
        "conv_w": dense_inits(generator, (d_conv, d_inner), dt, device,
                              fan_in=d_conv),
        "conv_b": full_inits((d_inner,), 0.0, dt, device),
        "x_proj": dense_inits(generator, (d_inner, dt_rank + 2 * d_state),
                              dt, device, fan_in=d_inner),
        "dt_proj": dense_inits(generator, (dt_rank, d_inner), dt, device,
                               fan_in=dt_rank),
        # softplus^-1(0.01)
        "dt_bias": full_inits((d_inner,), -4.6, f32, device),
        "A_log": a_log,
        "D": full_inits((d_inner,), 1.0, f32, device),
        "out_proj": dense_inits(generator, (d_inner, d), dt, device,
                                fan_in=d_inner),
    }


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as JAX promotes a float32
    activation against bfloat16 weights (torch refuses mixed operands)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over S. x: [B, S, C]; w: [K, C]. The K shifted
    multiply-adds in the JAX package's order — no cuDNN convolution, which
    would run float32 in TF32 on the card."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _ssm_inputs(params: Pytree, cfg: ModelConfig, u: torch.Tensor,
                tp=None):
    """u: [B, S, d_inner] -> (delta [B, S, d_inner] f32, A [d_inner,
    d_state] f32, B, C [B, S, d_state]): the factors of the discretised
    terms, which the JAX package's ``_ssm_inputs`` multiplies out. Under
    tensor parallelism ``u`` is the rank's block of d_inner (over the
    group ``tp``): ``x_proj``'s products are summed over the group, and
    (delta, A) are the block's."""
    d_inner, dt_rank, d_state, _ = _dims(cfg)
    proj = _matmul(u, params["x_proj"])
    if tp is not None:
        proj = enter(leave(proj, tp), tp)
    dt_raw, b_mat, c_mat = torch.split(proj, [dt_rank, d_state, d_state],
                                       dim=-1)
    # torch's softplus returns x above 20 where jax.nn.softplus is
    # logaddexp(x, 0); there log1p(exp(-x)) < 2.1e-9 is below half an f32
    # ulp of x, so the two agree to float32 rounding
    delta = torch.nn.functional.softplus(
        _matmul(dt_raw, params["dt_proj"]).float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    return delta, a, b_mat, c_mat


def _serve_share(params: Pytree, cfg: ModelConfig):
    """(the 'model' group, the rank's view of the mixer's parameters, its
    (first, count) of d_inner) in a serve step whose caches hold a block
    of d_inner; (None, params, None) otherwise. The leaves the rule
    splits are the rank's block already; a whole one (a 1-D leaf, or every
    leaf of a config whose weights the rule replicates) is cut here."""
    d_inner = _dims(cfg)[0]
    tp = serve_model()
    if not splits(tp, d_inner):
        return None, params, None
    lo, n = block(tp, d_inner)
    p = dict(params)
    for name, dim in (("conv_w", 1), ("dt_proj", 1), ("x_proj", 0),
                      ("A_log", 0), ("out_proj", 0), ("conv_b", 0),
                      ("dt_bias", 0), ("D", 0)):
        if p[name].shape[dim] == d_inner:
            p[name] = p[name].narrow(dim, lo, n)
    return tp, p, (lo, n)


def _in_projection(params: Pytree, cfg: ModelConfig, x: torch.Tensor, tp,
                   blk):
    """(u, gate) before the conv: the rank's block of d_inner of each
    (``blk``; the rule splits the fused ``[u | gate]`` columns of
    ``in_proj`` in contiguous blocks, so the ranks' columns are gathered
    first), or the whole of each."""
    y = x @ params["in_proj"]
    d_inner = _dims(cfg)[0]
    if y.shape[-1] < 2 * d_inner:
        y = gather_dim(tp or model_split(), y, y.dim() - 1)
    if blk is None:
        return torch.chunk(y, 2, dim=-1)
    lo, n = blk
    return y[..., lo:lo + n], y[..., d_inner + lo:d_inner + lo + n]


def apply_mamba_prefill(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                        return_state: bool = False, backend: str = "cuda"):
    """x: [B, S, D] -> [B, S, D] (+ the final (conv_state, ssm_state) if
    asked). The JAX package's ``apply_mamba_train(return_state=...)``; the
    recurrence is one selective-scan op call over the whole prompt from
    h = 0. With state, S must be a multiple of min(_CHUNK, S), the JAX
    package's contract (its scan carries state across chunks of _CHUNK).
    In a serve step whose caches split d_inner over 'model', the rank's
    block of d_inner (and of the state), ``out_proj``'s partial products
    summed (module docstring)."""
    check_backend(backend)
    _, s, _ = x.shape
    _, _, _, d_conv = _dims(cfg)
    if return_state and s % min(_CHUNK, s):
        raise ValueError("prefill requires seq_len % chunk == 0")
    if return_state and s < d_conv - 1:
        raise ValueError(f"prefill with state needs at least d_conv - 1 = "
                         f"{d_conv - 1} tokens, got {s}")
    tp, params, blk = _serve_share(params, cfg)
    ui, res = _in_projection(params, cfg, x, tp, blk)
    u = silu(_causal_conv(ui, params["conv_w"], params["conv_b"]))
    delta, a, b_mat, c_mat = _ssm_inputs(params, cfg, u, tp)
    scan = scan_ops.selective_scan if backend == "cuda" else selective_scan_ref
    y, h_last = scan(delta, u, a, b_mat, c_mat)
    y = y + params["D"] * u.float()
    y = y.to(x.dtype) * silu(res)
    out = sum_over(tp, y @ params["out_proj"])
    if not return_state:
        return out
    conv_state = ui[:, s - (d_conv - 1):].float()
    return out, (conv_state, h_last)


def _discretised(delta, a, b_mat, u):
    """(dA, dBu) [B, S, d_inner, d_state] float32: the JAX package's
    ``_ssm_inputs`` terms from their factors."""
    d_a = torch.exp(delta[..., None] * a)
    d_bu = (delta * u.float())[..., None] * b_mat.float()[..., None, :]
    return d_a, d_bu


def _scan_chunk(h, d_a, d_bu):
    """h [B, di, st]; d_a/d_bu [B, c, di, st] -> (h at the chunk's end,
    every h_t [B, c, di, st]). An inclusive associative scan of the
    combine (aL, bL) . (aR, bR) = (aL * aR, bL * aR + bR) by doubling
    (Hillis-Steele), then h_t = A_t * h + B_t."""
    c = d_a.shape[1]
    a_cum, b_cum = d_a, d_bu
    off = 1
    while off < c:
        a_r, b_r = a_cum[:, off:], b_cum[:, off:]
        a_cum, b_cum = (
            torch.cat([a_cum[:, :off], a_cum[:, :-off] * a_r], 1),
            torch.cat([b_cum[:, :off], b_cum[:, :-off] * a_r + b_r], 1))
        off *= 2
    h_all = a_cum * h[:, None] + b_cum
    return h_all[:, -1], h_all


def _split_params(params: Pytree, cfg: ModelConfig, tp) -> Pytree:
    """The rank's view of a Mamba mixer whose d_inner the rule splits:
    its whole per-channel vectors entered and cut to the rank's block."""
    d_inner = _dims(cfg)[0]
    p = enter_leaves(params, ["conv_b", "dt_bias", "D"])
    lo, n = block(tp, d_inner)
    for name in ("conv_b", "dt_bias", "D"):
        p[name] = p[name][lo:lo + n]
    return p


def apply_mamba_train(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                      chunk: int = _CHUNK, return_state: bool = False):
    """x: [B, S, D] -> [B, S, D] (+ the final (conv_state, ssm_state) if
    asked, which needs S % chunk == 0 so the final carry is exact).
    Differentiable; runs no kernel. Under tensor parallelism, over the
    rank's block of d_inner (module docstring)."""
    b, s, _ = x.shape
    d_inner, _, d_state, d_conv = _dims(cfg)
    tp = model_split()
    split = splits(tp, d_inner)
    if split and return_state:
        raise ValueError("apply_mamba_train: no final state of a d_inner "
                         "split over 'model' (a serving path)")
    if split:
        lo, n = block(tp, d_inner)
        params = _split_params(params, cfg, tp)
        y = gather_last_summed(enter(x) @ params["in_proj"])
        ui, res = y[..., lo:lo + n], y[..., d_inner + lo:d_inner + lo + n]
        d_inner = n
    else:
        ui, res = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    u = silu(_causal_conv(ui, params["conv_w"], params["conv_b"]))
    c = min(chunk, s)
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    if return_state and pad:
        raise ValueError("prefill requires seq_len % chunk == 0")
    u_p = torch.nn.functional.pad(u, (0, 0, 0, pad)) if pad else u
    delta, a, b_mat, c_mat = _ssm_inputs(params, cfg, u_p,
                                         tp if split else None)
    h = torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                    device=x.device)
    h_seq = []
    for i in range(n_chunks):
        cs = slice(i * c, (i + 1) * c)
        d_a, d_bu = _discretised(delta[:, cs], a, b_mat[:, cs], u_p[:, cs])
        h, h_all = _scan_chunk(h, d_a, d_bu)
        h_seq.append(h_all)
    h_seq = torch.cat(h_seq, 1)[:, :s]
    # y[b,t,i] = sum_s h[b,t,i,s] * C[b,t,s]: an elementwise product and
    # sum, not a matmul (no TF32 on the card)
    y = (h_seq * c_mat[:, :s].float()[:, :, None, :]).sum(-1)
    y = y + params["D"] * u.float()
    y = y.to(x.dtype) * silu(res)
    out = y @ params["out_proj"]
    if split:
        return leave(out)
    if not return_state:
        return out
    conv_state = ui[:, s - (d_conv - 1):].float()
    return out, (conv_state, h)


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [n_slots, B, d_conv-1, d_inner] f32
    ssm: torch.Tensor    # [n_slots, B, d_inner, d_state] f32

    @staticmethod
    def init(cfg: ModelConfig, n_slots: int, batch: int,
             device, cut=None) -> "MambaCache":
        """Zeros. ``cut(field, shape)`` gives a rank's block of a leaf of
        the whole ``shape`` (a serve plan's ``cache_shape``)."""
        d_inner, _, d_state, d_conv = _dims(cfg)
        conv = (n_slots, batch, d_conv - 1, d_inner)
        ssm = (n_slots, batch, d_inner, d_state)
        if cut is not None:
            conv, ssm = cut("conv", conv), cut("ssm", ssm)
        f32 = torch.float32
        return MambaCache(torch.zeros(conv, dtype=f32, device=device),
                          torch.zeros(ssm, dtype=f32, device=device))


def apply_mamba_decode(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                       cache: MambaCache, slot: int
                       ) -> Tuple[torch.Tensor, MambaCache]:
    """x: [B, 1, D] single-token recurrent update; writes the conv and ssm
    state at ``slot`` in place (in a serve step whose caches split d_inner
    over 'model', the rank's block of both)."""
    tp, params, blk = _serve_share(params, cfg)
    ui, res = _in_projection(params, cfg, x[:, 0], tp, blk)     # [B, di]
    window = torch.cat([cache.conv[slot], ui.float()[:, None]],
                       dim=1)                                   # [B,d_conv,di]
    u = silu(torch.einsum("bkc,kc->bc", window, params["conv_w"].float())
             + params["conv_b"].float())
    delta, a, b_mat, c_mat = _ssm_inputs(params, cfg, u[:, None], tp)  # S=1
    dA = torch.exp(delta[:, 0, :, None] * a)                       # [B,di,st]
    dBu = (delta[:, 0] * u)[..., None] * b_mat[:, 0, None, :].float()
    h = dA * cache.ssm[slot] + dBu
    y = torch.einsum("bis,bs->bi", h, c_mat[:, 0].float())
    y = y + params["D"] * u
    y = y.to(x.dtype) * silu(res)
    out = sum_over(tp, y @ params["out_proj"])[:, None]
    cache.conv[slot] = window[:, 1:]
    cache.ssm[slot] = h
    return out, cache
