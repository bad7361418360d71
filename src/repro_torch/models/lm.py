"""Full language model: embeddings -> blocks -> head, with the train loss
and the prefill / decode entry points the launchers drive.

The port of the JAX package's ``repro.models.lm``.
``input_mode='embeds'`` is the stub modality frontend of the [audio]/[vlm]
archs: the model consumes precomputed frame/patch embeddings instead of
token ids.

Training: :func:`lm_loss_and_stats` is next-token cross-entropy over
``backbone_train``'s hidden states, computed in sequence chunks of
``_LOSS_CHUNK`` under ``torch.utils.checkpoint`` (outside any ODE
dynamics, so plain autograd applies), so the full [B, S, vocab] logits
never exist (vocab up to 256k makes them tens of GB); it returns the
summed ODE counters beside the loss.

Serving: ``prefill`` and ``decode_step`` take ``backend``: ``"cuda"``
(default) sends RMSNorm, prompt attention, the Mamba prompt scan and the
ALF state updates through the port's kernel ops (the hand-written kernels
on the card, their plain versions on the CPU); ``"reference"`` runs the
plain versions on any device, the yardstick the kernel path is held
against on the card. Both run without autograd; the cache in ``state``
is written in place. ``ServeState.pos`` is a 0-d int32 tensor on the
cache's device, as in the JAX package, and no host reads it, so a decode
step can be captured in a CUDA graph and replayed
(``launch.serve.make_decode_step``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.interface import RunStats
from repro_torch.device import resolve_device

from .common import (embed_init, materialize, rmsnorm, rmsnorm_inits,
                     softcap, torch_dtype)
from .transformer import blocks_serve, blocks_train, init_blocks, init_cache

Pytree = Any

_LOSS_CHUNK = 512


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            device=None) -> Pytree:
    """Seeded random weights in the JAX package's tree layout, on
    ``device`` (default: the CUDA card); ``generator`` must live on that
    device. Raises ``NotImplementedError`` for layer kinds not ported
    yet."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    params = {
        "embed": embed_init(generator, (cfg.vocab_size, cfg.d_model), dt,
                            dev),
        "blocks": init_blocks(generator, cfg, dev),
        "final_norm": materialize(rmsnorm_inits(cfg.d_model, dt, dev)),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(generator, (cfg.d_model, cfg.vocab_size),
                                    dt, dev)
    return params


def _head_matrix(params: Pytree, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _embed(params: Pytree, cfg: ModelConfig, batch: Pytree) -> torch.Tensor:
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.input_mode == "embeds":
        return batch["embeds"].to(cdt)
    return params["embed"][batch["tokens"]].to(cdt)


def _logits(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
            backend: str) -> torch.Tensor:
    h = rmsnorm(params["final_norm"], x, backend=backend)
    logits = (h @ _head_matrix(params, cfg)).float()
    return softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def backbone_train(params: Pytree, cfg: ModelConfig, batch: Pytree
                   ) -> Tuple[torch.Tensor, RunStats]:
    """Returns (final hidden states, summed ODE RunStats — int32 counters
    from every residual-branch solve; zeros with ode.mode='off')."""
    x = _embed(params, cfg, batch)
    x, stats = blocks_train(params["blocks"], cfg, x, None)
    return rmsnorm(params["final_norm"], x, backend="reference"), stats


def _chunk_nll(hc: torch.Tensor, lc: torch.Tensor, head: torch.Tensor,
               cap: float) -> torch.Tensor:
    """Summed next-token NLL of one sequence chunk (labels < 0 count 0)."""
    logits = softcap((hc @ head).float(), cap)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lc.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(lc >= 0, lse - tgt, 0.0).sum()


def chunked_ce_loss(h: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, cfg: ModelConfig,
                    chunk: int = _LOSS_CHUNK) -> torch.Tensor:
    """Mean next-token CE without materializing [B, S, vocab]: the chunks'
    sums in sequence order, each chunk recomputed in the backward
    (``checkpoint``), over the count of labels >= 0."""
    s = h.shape[1]
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    h_p = torch.nn.functional.pad(h, (0, 0, 0, pad))
    l_p = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        cs = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_nll, h_p[:, cs], l_p[:, cs], head,
                                   cfg.final_softcap, use_reentrant=False,
                                   preserve_rng_state=False)
    count = (labels >= 0).sum(dtype=torch.int32)
    return total / torch.clamp_min(count, 1)


def lm_loss_and_stats(params: Pytree, cfg: ModelConfig, batch: Pytree
                      ) -> Tuple[torch.Tensor, RunStats]:
    """Like :func:`lm_loss` but also returns the integration accounting
    (the counters are integer outputs that autograd leaves alone)."""
    h, stats = backbone_train(params, cfg, batch)
    loss = chunked_ce_loss(h, _head_matrix(params, cfg), batch["labels"], cfg)
    return loss, stats


def lm_loss(params: Pytree, cfg: ModelConfig, batch: Pytree) -> torch.Tensor:
    """batch: {'tokens' | 'embeds', 'labels'} with labels already shifted."""
    return lm_loss_and_stats(params, cfg, batch)[0]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class ServeState(NamedTuple):
    cache: Pytree
    pos: torch.Tensor   # next write position, 0-d int32 on the device


def _position(value: int, device) -> torch.Tensor:
    """A 0-d int32 position on ``device``, made by a fill kernel (no
    host-to-device copy, no sync)."""
    return torch.full((), value, dtype=torch.int32, device=device)


def init_serve_state(cfg: ModelConfig, batch: int, s_max: int,
                     device=None) -> ServeState:
    dev = resolve_device(device)
    return ServeState(init_cache(cfg, batch, s_max, dev), _position(0, dev))


@torch.no_grad()
def prefill(params: Pytree, cfg: ModelConfig, batch: Pytree,
            state: ServeState, backend: str = "cuda"
            ) -> Tuple[torch.Tensor, ServeState]:
    """Process the prompt; returns last-position logits [B, 1, V] (f32)
    and the state with the filled cache."""
    x = _embed(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    x, cache = blocks_serve(params["blocks"], cfg, x, state.cache,
                            positions, "prefill", backend)
    return (_logits(params, cfg, x[:, -1:], backend),
            ServeState(cache, _position(s, x.device)))


@torch.no_grad()
def decode_step(params: Pytree, cfg: ModelConfig,
                tokens_or_embeds: torch.Tensor, state: ServeState,
                backend: str = "cuda") -> Tuple[torch.Tensor, ServeState]:
    """One decode step. tokens [B, 1] int (or [B, 1, D] embeds); returns
    logits [B, 1, V] (f32)."""
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.input_mode == "embeds" and tokens_or_embeds.dim() == 3:
        x = tokens_or_embeds.to(cdt)
    else:
        x = params["embed"][tokens_or_embeds].to(cdt)
    x, cache = blocks_serve(params["blocks"], cfg, x, state.cache,
                            state.pos, "decode", backend)
    return (_logits(params, cfg, x, backend),
            ServeState(cache, state.pos + 1))
