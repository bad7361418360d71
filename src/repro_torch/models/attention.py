"""GQA attention, serve paths: RoPE, qk-norm, logit softcap, sliding
window, KV cache.

The port of the serve parts of the JAX package's ``repro.models.attention``:

  * ``attention_prefill`` — full-prompt causal attention through the
    flash-attention op (the hand-written kernel on the card, its plain
    version on the CPU or with ``backend="reference"``), writing K/V into
    the cache slot. The JAX package computes the same function with its
    direct einsum (``_sdpa_direct``) or chunked online softmax; its Pallas
    kernel is the TPU's version of this hot path.
  * ``attention_decode`` — a one-token query against the cache, with the
    direct grouped einsum ``_sdpa_direct`` over the whole cache and a
    position mask, as in the JAX package (its flash kernel fixes query
    positions at 0..Sq-1 and so cannot serve a query at ``pos``).

The ``slot`` axis of the cache is the *virtual layer* index of
continuous-depth mode: every ALF f-eval inside a block gets its own KV
slot; slot 0 is used when ode.mode == 'off'. The training path
(``attention_train`` and its FA2 backward) comes with the training slice.

Caches are written in place (the JAX package returns updated copies);
each function still returns the cache it was given.

Shapes: activations [B, S, D]; q/k/v [B, S, H|K, d_head]; caches
k/v: [n_slots, B, S_max, K, d_head].
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.alf import check_backend
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref

from .common import (apply_rope, dense_inits, rmsnorm, rmsnorm_inits,
                     softcap, torch_dtype)

Pytree = Any

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax NaN-free on fully-masked rows


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


def _finish(params, b, s, out):
    return out.reshape(b, s, -1) @ params["wo"]


def _window(cfg: ModelConfig, spec: LayerSpec) -> int:
    return cfg.sliding_window if spec.attn_kind == "local" else 0


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
