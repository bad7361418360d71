"""GQA attention: RoPE, qk-norm, logit softcap, sliding window, KV cache.

The port of the JAX package's ``repro.models.attention``. Three execution
paths:

  * ``attention_train`` — full-sequence causal attention, differentiable.
    Sequences up to ``_DIRECT_SEQ_LIMIT`` use the direct grouped einsum
    (``_sdpa_direct``); longer ones the chunked online softmax over
    (``_BLOCK_Q`` x ``_BLOCK_KV``) tiles with the FlashAttention-2-style
    backward (``_FlashSdpa``: the forward keeps only (q, k, v, out, lse),
    the backward recomputes each tile), or with ``cfg.attn_bwd !=
    "flash"`` autograd through the same tiles (``_sdpa_chunked``). All in
    plain PyTorch with float32 tiles, as the JAX package's jnp versions:
    the flash-attention kernel is forward-only in both packages, and
    training runs none of the LM kernels (the q/k norms too are the plain
    RMSNorm).
  * ``attention_prefill`` — full-prompt causal attention through the
    flash-attention op (the hand-written kernel on the card, its plain
    version on the CPU or with ``backend="reference"``), writing K/V into
    the cache slot. The JAX package computes the same function with its
    direct einsum or chunked online softmax; its Pallas kernel is the
    TPU's version of this hot path.
  * ``attention_decode`` — a one-token query against the cache, with the
    direct grouped einsum ``_sdpa_direct`` over the whole cache and a
    position mask, as in the JAX package (its flash kernel fixes query
    positions at 0..Sq-1 and so cannot serve a query at ``pos``).

The chunked paths skip the tiles that the causal (and window) mask hides
from every query row of the tile: the JAX package computes them, and they
change nothing (a fully masked tile adds exact zeros to the running sums
and to every gradient), so the results are the same and the causal work
halves. The JAX package's sharding hints (``hint``) place arrays on a TPU
mesh; the port runs on one card and has none.

The ``slot`` axis of the cache is the *virtual layer* index of
continuous-depth mode: every ALF f-eval inside a block gets its own KV
slot; slot 0 is used when ode.mode == 'off'.

Caches are written in place (the JAX package returns updated copies);
each function still returns the cache it was given.

Shapes: activations [B, S, D]; q/k/v [B, S, H|K, d_head]; caches
k/v: [n_slots, B, S_max, K, d_head].
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.alf import check_backend
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

from .common import (apply_rope, dense_inits, rmsnorm, rmsnorm_inits,
                     softcap, torch_dtype)

Pytree = Any

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax NaN-free on fully-masked rows

# Direct-einsum threshold of the training path; above it the chunked
# online softmax runs over (_BLOCK_Q x _BLOCK_KV) tiles, so the scores
# never exist as [B, H, S, S] float32.
_DIRECT_SEQ_LIMIT = 2048
_BLOCK_Q = 512
_BLOCK_KV = 1024


def attention_inits(generator: torch.Generator, cfg: ModelConfig,
                    device) -> Pytree:
    """Leaf initializers (``common.materialize``) of one attention
    mixer."""
    dt = torch_dtype(cfg.param_dtype)
    d, h, k_, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    params = {
        "wq": dense_inits(generator, (d, h * dh), dt, device),
        "wk": dense_inits(generator, (d, k_ * dh), dt, device),
        "wv": dense_inits(generator, (d, k_ * dh), dt, device),
        "wo": dense_inits(generator, (h * dh, d), dt, device, fan_in=h * dh),
    }
    if cfg.qk_norm:
        params["q_norm"] = rmsnorm_inits(dh, dt, device)
        params["k_norm"] = rmsnorm_inits(dh, dt, device)
    return params


def _project_qkv(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, backend: str = "cuda"):
    b, s, _ = x.shape
    h, k_, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, k_, dh)
    v = (x @ params["wv"]).reshape(b, s, k_, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, backend=backend)
        k = rmsnorm(params["k_norm"], k, backend=backend)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """[Sq, Sk] additive bias: causal (+ sliding window if window > 0)."""
    keep = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        keep &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(keep, 0.0, NEG_INF).float()


def _sdpa_direct(cfg: ModelConfig, q, k, v, bias) -> torch.Tensor:
    """[B,Sq,H,dh] x [B,Sk,K,dh] grouped attention, f32 accumulation."""
    b, sq, h, dh = q.shape
    k_heads = k.shape[2]
    g = h // k_heads
    qg = q.reshape(b, sq, k_heads, g, dh)
    scale = dh ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    scores = softcap(scores, cfg.attn_softcap)
    scores = scores + bias[None, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


Tiles = Tuple[Tuple[int, ...], ...]


def _chunk_arrays(q, k, v, q_pos, k_pos, block_q: int, block_kv: int):
    """Pad q/k/v for the blocked paths: K/V repeated to the full head
    count (the GQA -> MHA layout of the JAX package's ``_chunk_arrays``),
    q padded to a multiple of ``block_q`` (padding rows at position -1),
    k/v to a multiple of ``block_kv`` (padding keys at position 2^30, so
    the causal mask hides them). The JAX package also tiles the arrays
    into [n_blocks, ...] stacks for its scans; the port slices the padded
    arrays per tile instead. Returns (q, k, v, q_pos, k_pos)."""
    h = q.shape[2]
    if k.shape[2] != h:
        rep = h // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    sq, sk = q.shape[1], k.shape[1]
    pad_q = -(-sq // block_q) * block_q - sq
    pad_kv = -(-sk // block_kv) * block_kv - sk
    pad = torch.nn.functional.pad
    return (pad(q, (0, 0, 0, 0, 0, pad_q)), pad(k, (0, 0, 0, 0, 0, pad_kv)),
            pad(v, (0, 0, 0, 0, 0, pad_kv)),
            pad(q_pos, (0, pad_q), value=-1),
            pad(k_pos, (0, pad_kv), value=2 ** 30))


def _live_tiles(sq: int, sk: int, window: int, block_q: int, block_kv: int,
                causal_arange: bool) -> Tiles:
    """For each query block, the key blocks whose tile the mask does not
    hide from every query row of the block. ``causal_arange``: query and
    key positions are 0..S-1 (``attention_train``'s own positions), so
    the mask is known on the host; otherwise every tile is live."""
    nq, nkv = -(-sq // block_q), -(-sk // block_kv)
    if not causal_arange:
        return tuple(tuple(range(nkv)) for _ in range(nq))
    tiles = []
    for i in range(nq):
        q_lo, q_hi = i * block_q, min((i + 1) * block_q, sq) - 1
        live = []
        for j in range(nkv):
            k_lo, k_hi = j * block_kv, min((j + 1) * block_kv, sk) - 1
            if k_lo <= q_hi and (window <= 0 or k_hi > q_lo - window):
                live.append(j)
        tiles.append(tuple(live))
    return tuple(tiles)


def _tile_scores(qb, kb, qpb, kpb, cap: float, window: int, scale: float):
    """(capped scores before the mask, masked scores) of one tile:
    qb [B, bq, H, dh], kb [B, bk, H, dh] float32 -> [B, H, bq, bk]."""
    s_c = softcap(torch.einsum("bqhd,bshd->bhqs", qb, kb) * scale, cap)
    return s_c, s_c + _mask_bias(qpb, kpb, window)[None, None]


def _flash_forward(q, k, v, q_pos, k_pos, cap: float, window: int,
                   scale: float, block_q: int, block_kv: int, tiles: Tiles):
    """Online softmax over the live tiles of padded q [B, Sqp, H, dh] and
    k/v [B, Skp, H, dh]: (out [B, Sqp, H, dh] float32, lse [B, H, Sqp]
    float32; +inf on rows that see no key, so the backward's p is 0
    there)."""
    b, _, h, dh = q.shape
    outs, lses = [], []
    for i, live in enumerate(tiles):
        qs = slice(i * block_q, (i + 1) * block_q)
        qb, qpb = q[:, qs].float(), q_pos[qs]
        m = torch.full((b, h, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, block_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, block_q, dh), dtype=torch.float32,
                          device=q.device)
        for j in live:
            ks = slice(j * block_kv, (j + 1) * block_kv)
            _, s = _tile_scores(qb, k[:, ks].float(), qpb, k_pos[ks], cap,
                                window, scale)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p, v[:, ks].float())
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
        lses.append(torch.where(
            l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), torch.inf))
    out = torch.cat(outs, 2).transpose(1, 2)          # [B, Sqp, H, dh]
    return out, torch.cat(lses, 2)


class _FlashSdpa(torch.autograd.Function):
    """FlashAttention-2-style attention over padded q/k/v (the JAX
    package's ``_make_flash_sdpa`` custom_vjp).

    Forward: :func:`_flash_forward`; saved for the backward are (q, k, v,
    out, lse), O(S * d), and no tile. Backward: recompute each live
    (q-block, kv-block) tile from (q, k, lse), accumulate dq, dk, dv —
    standard FA2, with the softcap chain rule
    ``ds = ds_c * (1 - (s_c / cap)^2)``. dk and dv add the q-blocks'
    contributions in block order, as the JAX package's scan does.

    Written in the ``forward`` + ``setup_context`` style, as
    ``torch.func`` requires: MALI's backward runs the dynamics (this
    Function inside) under ``torch.func.vjp``."""

    @staticmethod
    def forward(q, k, v, q_pos, k_pos, cap, window, scale, block_q,
                block_kv, tiles):
        return _flash_forward(q, k, v, q_pos, k_pos, cap, window, scale,
                              block_q, block_kv, tiles)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, q_pos, k_pos, cap, window, scale, block_q, block_kv, \
            tiles = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.args = (cap, window, scale, block_q, block_kv, tiles)

    @staticmethod
    def backward(ctx, g_out, _g_lse):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        cap, window, scale, block_q, block_kv, tiles = ctx.args
        g = g_out.float()
        # delta_i = sum_d dO_i * O_i  (FA2)
        delta = (g * out.float()).sum(-1).transpose(1, 2)    # [B, H, Sqp]
        nkv = k.shape[1] // block_kv
        dk = [None] * nkv
        dv = [None] * nkv
        dqs = []
        for i, live in enumerate(tiles):
            qs = slice(i * block_q, (i + 1) * block_q)
            qb, dob, qpb = q[:, qs].float(), g[:, qs], q_pos[qs]
            lse_b, delta_b = lse[..., qs], delta[..., qs]
            dq_b = torch.zeros_like(qb)
            for j in live:
                ks = slice(j * block_kv, (j + 1) * block_kv)
                kb, vb = k[:, ks].float(), v[:, ks].float()
                s_c, s = _tile_scores(qb, kb, qpb, k_pos[ks], cap, window,
                                      scale)
                p = torch.exp(s - lse_b[..., None])          # [B,H,bq,bk]
                dv_t = torch.einsum("bhqs,bqhd->bshd", p, dob)
                dp = torch.einsum("bqhd,bshd->bhqs", dob, vb)
                ds = p * (dp - delta_b[..., None])
                if cap > 0:
                    ds = ds * (1.0 - (s_c / cap) ** 2)
                ds = ds * scale
                dq_b = dq_b + torch.einsum("bhqs,bshd->bqhd", ds, kb)
                dk_t = torch.einsum("bhqs,bqhd->bshd", ds, qb)
                dk[j] = dk_t if dk[j] is None else dk[j] + dk_t
                dv[j] = dv_t if dv[j] is None else dv[j] + dv_t
            dqs.append(dq_b)
        zeros = torch.zeros((k.shape[0], block_kv, *k.shape[2:]),
                            dtype=torch.float32, device=k.device)
        dk = torch.cat([zeros if t is None else t for t in dk], 1)
        dv = torch.cat([zeros if t is None else t for t in dv], 1)
        return (torch.cat(dqs, 1).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None, None, None, None, None,
                None)


def _sdpa_chunked_flash(cfg: ModelConfig, q, k, v, q_pos, k_pos, window,
                        block_q: int = _BLOCK_Q, block_kv: int = _BLOCK_KV,
                        tiles: Optional[Tiles] = None) -> torch.Tensor:
    """Differentiable chunked attention with the FA2-style backward.
    q [B, Sq, H, dh]; k/v [B, Sk, K, dh]; q_pos [Sq], k_pos [Sk];
    ``tiles`` from :func:`_live_tiles` (default: every tile)."""
    b, sq, h, dh = q.shape
    qp, kp, vp, qpos, kpos = _chunk_arrays(q, k, v, q_pos, k_pos, block_q,
                                           block_kv)
    if tiles is None:
        tiles = _live_tiles(sq, k.shape[1], window, block_q, block_kv, False)
    out, _ = _FlashSdpa.apply(qp, kp, vp, qpos, kpos,
                              float(cfg.attn_softcap), int(window),
                              float(dh ** -0.5), block_q, block_kv, tiles)
    return out[:, :sq].to(q.dtype)


def _sdpa_chunked(cfg: ModelConfig, q, k, v, q_pos, k_pos, window,
                  block_q: int = _BLOCK_Q, block_kv: int = _BLOCK_KV,
                  tiles: Optional[Tiles] = None) -> torch.Tensor:
    """The same online softmax as :func:`_sdpa_chunked_flash`, with
    autograd through the tiles (``cfg.attn_bwd != "flash"``): the
    backward keeps every tile's probabilities."""
    b, sq, h, dh = q.shape
    qp, kp, vp, qpos, kpos = _chunk_arrays(q, k, v, q_pos, k_pos, block_q,
                                           block_kv)
    if tiles is None:
        tiles = _live_tiles(sq, k.shape[1], window, block_q, block_kv, False)
    out, _ = _flash_forward(qp, kp, vp, qpos, kpos, float(cfg.attn_softcap),
                            int(window), float(dh ** -0.5), block_q,
                            block_kv, tiles)
    return out[:, :sq].to(q.dtype)


def _finish(params, b, s, out):
    return out.reshape(b, s, -1) @ params["wo"]


def _window(cfg: ModelConfig, spec: LayerSpec) -> int:
    return cfg.sliding_window if spec.attn_kind == "local" else 0


def attention_train(params: Pytree, cfg: ModelConfig, spec: LayerSpec,
                    x: torch.Tensor,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable causal self-attention over x [B, S, D]. Without
    ``positions`` (the training path's case) the positions are 0..S-1,
    made here, and the chunked path skips the tiles the mask hides. The
    q/k norms run the plain RMSNorm."""
    b, s, _ = x.shape
    given = positions is not None
    if not given:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    window = _window(cfg, spec)
    q, k, v = _project_qkv(params, cfg, x, positions, backend="reference")
    pos = positions[0]
    if s <= _DIRECT_SEQ_LIMIT:
        out = _sdpa_direct(cfg, q, k, v, _mask_bias(pos, pos, window))
    else:
        tiles = _live_tiles(s, s, window, _BLOCK_Q, _BLOCK_KV, not given)
        chunked = (_sdpa_chunked_flash if cfg.attn_bwd == "flash"
                   else _sdpa_chunked)
        out = chunked(cfg, q, k, v, pos, pos, window, tiles=tiles)
    return _finish(params, b, s, out)


class KVCache(NamedTuple):
    k: torch.Tensor  # [n_slots, B, S_max, K, dh]
    v: torch.Tensor

    @staticmethod
    def init(cfg: ModelConfig, n_slots: int, batch: int, s_max: int,
             device) -> "KVCache":
        dt = torch_dtype(cfg.compute_dtype)
        shape = (n_slots, batch, s_max, cfg.n_kv_heads, cfg.d_head)
        return KVCache(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device))


def attention_prefill(params: Pytree, cfg: ModelConfig, spec: LayerSpec,
                      x: torch.Tensor, positions: torch.Tensor,
                      cache: KVCache, slot: int, backend: str = "cuda"
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Prompt attention; ``positions`` are ``arange(S)`` per row, as
    ``lm.prefill`` makes them (the flash op puts query i at position i).
    Writes K/V into ``cache[slot, :, :S]`` in place."""
    check_backend(backend)
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions, backend)
    cache.k[slot, :, :s] = k
    cache.v[slot, :, :s] = v
    attend = flash_ops.flash_attention if backend == "cuda" else attention_ref
    out = attend(q, k, v, causal=True, window=_window(cfg, spec),
                 softcap=cfg.attn_softcap)
    return _finish(params, b, s, out), cache


def attention_decode(params: Pytree, cfg: ModelConfig, spec: LayerSpec,
                     x: torch.Tensor, pos: torch.Tensor, cache: KVCache,
                     slot: int, backend: str = "cuda"
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: x [B, 1, D]; pos the current position, a 0-d int
    tensor on x's device (never read on the host). Writes K/V at
    ``cache[slot, :, pos]`` in place."""
    check_backend(backend)
    b = x.shape[0]
    positions = pos.reshape(1, 1).expand(b, 1)
    q, k, v = _project_qkv(params, cfg, x, positions, backend)
    at = pos.reshape(1).long()
    cache.k[slot].index_copy_(1, at, k)
    cache.v[slot].index_copy_(1, at, v)
    k_all, v_all = cache.k[slot], cache.v[slot]
    k_pos = torch.arange(k_all.shape[1], dtype=torch.int32, device=x.device)
    bias = _mask_bias(positions[0], k_pos, _window(cfg, spec))   # [1, S]
    out = _sdpa_direct(cfg, q, k_all, v_all, bias)
    return _finish(params, b, 1, out), cache
