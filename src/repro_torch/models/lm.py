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
summed ODE counters beside the loss. In a training step over a mesh the
embedding and the head are gathered over 'data' where they are used
(FSDP), and under tensor parallelism the embedding (split on D) gives
each rank its columns of the lookup, gathered over 'model', and the head
(split on the vocabulary) computes a vocab-parallel cross-entropy: each
rank's logits are its vocabulary block, and the maximum, the sum of
exponentials and the label's logit are reduced over 'model' (three
floats a token cross the group, where gathering the logits would move a
chunk's [B, 512, V / M] a rank). A tied head (the embedding's transpose,
split on D) sums its partial logits over 'model' instead.

Serving: ``prefill`` and ``decode_step`` take ``backend``: ``"cuda"``
(default) sends RMSNorm, prompt attention, the Mamba prompt scan and the
ALF state updates through the port's kernel ops (the hand-written kernels
on the card, their plain versions on the CPU); ``"reference"`` runs the
plain versions on any device, the yardstick the kernel path is held
against on the card. Both run without autograd; the cache in ``state``
is written in place. ``ServeState.pos`` is a 0-d int32 tensor on the
cache's device, as in the JAX package, and no host reads it, so a decode
step can be captured in a CUDA graph and replayed
(``launch.serve.make_decode_step``). Under an ambient mesh of several
ranks (``with mesh:``) the two serve the JAX package's layout by its
rules: ``params`` are the rank's shards (``ServePlan.param_shards``, or
``init_lm(..., cut=plan.cut)``), the state the rank's blocks of the
caches (:func:`init_serve_state`), and the batch in and the logits out
the global batch's; each rank computes its rows, the layers split over
'model', and the head's logits are gathered over 'model' and over the
rows (:class:`~repro_torch.distributed.data_parallel.ServePlan`).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.interface import RunStats
from repro_torch.device import resolve_device
from repro_torch.distributed.data_parallel import (fsdp_gathered, row_split,
                                                   serve_plan_for)
from repro_torch.distributed.sharding import ambient_mesh
from repro_torch.distributed.tensor_parallel import (block, enter,
                                                     gather_last, leave,
                                                     model_split, splits)

from .common import (embed_init, materialize, rmsnorm, rmsnorm_inits,
                     softcap, torch_dtype)
from .transformer import blocks_serve, blocks_train, init_blocks, init_cache

Pytree = Any

_LOSS_CHUNK = 512


def init_lm(generator: torch.Generator, cfg: ModelConfig,
            device=None, cut=None) -> Pytree:
    """Seeded random weights in the JAX package's tree layout, on
    ``device`` (default: the CUDA card); ``generator`` must live on that
    device. ``cut(names, leaf, period=False)`` (a serve plan's ``cut``)
    keeps a rank's block of each leaf as it is drawn: every rank draws
    the same numbers and holds its blocks plus one whole leaf at a
    time."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.param_dtype)
    keep = cut or (lambda names, leaf: leaf)
    params = {
        "embed": keep(("embed",), embed_init(
            generator, (cfg.vocab_size, cfg.d_model), dt, dev)),
        "blocks": init_blocks(generator, cfg, dev, cut),
        "final_norm": materialize(rmsnorm_inits(cfg.d_model, dt, dev)),
    }
    if not cfg.tie_embeddings:
        params["head"] = keep(("head",), embed_init(
            generator, (cfg.d_model, cfg.vocab_size), dt, dev))
    return params


def _head_matrix(params: Pytree, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _head_params(params: Pytree, cfg: ModelConfig) -> Pytree:
    """The leaves :func:`_head_matrix` reads."""
    name = "embed" if cfg.tie_embeddings else "head"
    return {name: params[name]}


def _embed(params: Pytree, cfg: ModelConfig, batch: Pytree) -> torch.Tensor:
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.input_mode == "embeds":
        return batch["embeds"].to(cdt)
    return _embed_tokens(params, cfg, batch["tokens"])


def _embed_tokens(params: Pytree, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` in the compute dtype (on a mesh:
    the table gathered over 'data', the ranks' column blocks over
    'model')."""
    with fsdp_gathered({"embed": params["embed"]}) as p:
        # F.embedding, not p["embed"][tokens]: on the CPU the indexing's
        # backward accumulates in an order that varies with the threads
        x = torch.nn.functional.embedding(tokens, p["embed"])
    if splits(model_split(), cfg.d_model):
        x = gather_last(x)        # the ranks' column blocks of the rows
    return x.to(torch_dtype(cfg.compute_dtype))


def _logits(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
            backend: str) -> torch.Tensor:
    """The serve path's float32 logits of ``x``. On a mesh the head is
    gathered over 'data' and, where the rule splits it over 'model', each
    rank multiplies its block: of the vocabulary (its logits gathered
    over 'model', in float32) or, for a tied head, of D (the float32
    partial logits summed over 'model')."""
    h = rmsnorm(params["final_norm"], x, backend=backend)
    tp = model_split()
    with fsdp_gathered(_head_params(params, cfg)) as p:
        head = _head_matrix(p, cfg)
        if cfg.tie_embeddings and splits(tp, cfg.d_model):
            lo, n = block(tp, cfg.d_model)
            logits = leave((h[..., lo:lo + n] @ head).float())
        elif not cfg.tie_embeddings and splits(tp, cfg.vocab_size):
            logits = gather_last((h @ head).float())
        else:
            logits = (h @ head).float()
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
               cap: float, split: str = "") -> torch.Tensor:
    """Summed next-token NLL of one sequence chunk (labels < 0 count 0).
    Under tensor parallelism ``head`` is the rank's block: of the
    vocabulary (``split="vocab"``) or of D (``"rows"``, a tied head)."""
    if split == "vocab":
        return _chunk_nll_vocab(hc, lc, head, cap)
    if split == "rows":
        lo, n = block(model_split(), hc.shape[-1])
        logits = softcap(leave((enter(hc)[..., lo:lo + n] @ head).float()),
                         cap)
    else:
        logits = softcap((hc @ head).float(), cap)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lc.clamp_min(0).long()[..., None])[..., 0]
    return torch.where(lc >= 0, lse - tgt, 0.0).sum()


def _chunk_nll_vocab(hc: torch.Tensor, lc: torch.Tensor, head: torch.Tensor,
                     cap: float) -> torch.Tensor:
    """:func:`_chunk_nll` over the rank's vocabulary block: the
    log-sum-exp from the group's maximum and summed exponentials, the
    label's logit from the rank that holds it."""
    tp = model_split()
    logits = softcap((enter(hc) @ head).float(), cap)      # [B, c, V / M]
    m = tp.all_reduce(logits.detach().amax(-1),
                      op=torch.distributed.ReduceOp.MAX)
    lse = m + torch.log(leave(torch.exp(logits - m[..., None]).sum(-1)))
    lo, n = tp.rank * logits.shape[-1], logits.shape[-1]
    mine = (lc >= lo) & (lc < lo + n)
    tgt = torch.gather(logits, -1, (lc - lo).clamp(0, n - 1).long()[..., None]
                       )[..., 0]
    tgt = leave(torch.where(mine, tgt, 0.0))
    return torch.where(lc >= 0, lse - tgt, 0.0).sum()


def chunked_ce_loss(h: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, cfg: ModelConfig,
                    chunk: int = _LOSS_CHUNK) -> torch.Tensor:
    """Mean next-token CE without materializing [B, S, vocab]: the chunks'
    sums in sequence order, each chunk recomputed in the backward
    (``checkpoint``), over the count of labels >= 0. Under data
    parallelism (rows split over a group) the count is the group's, so
    the loss is this rank's share of the global mean: the shares sum to
    it, and so do their gradients. Under tensor parallelism ``head`` is
    the rank's block of the rule's split (module docstring)."""
    tp = model_split()
    split = ""
    if cfg.tie_embeddings and splits(tp, cfg.d_model):
        split = "rows"
    elif not cfg.tie_embeddings and splits(tp, cfg.vocab_size):
        split = "vocab"
    s = h.shape[1]
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    h_p = torch.nn.functional.pad(h, (0, 0, 0, pad))
    l_p = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        cs = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_nll, h_p[:, cs], l_p[:, cs], head,
                                   cfg.final_softcap, split,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    count = (labels >= 0).sum(dtype=torch.int32)
    split_rows = row_split()
    if split_rows is not None:
        count = split_rows.all_reduce(count)
    return total / torch.clamp_min(count, 1)


def lm_loss_and_stats(params: Pytree, cfg: ModelConfig, batch: Pytree
                      ) -> Tuple[torch.Tensor, RunStats]:
    """Like :func:`lm_loss` but also returns the integration accounting
    (the counters are integer outputs that autograd leaves alone). In a
    training step over a mesh the head is gathered over 'data' for the
    loss (once: its chunks' recomputations reuse it)."""
    h, stats = backbone_train(params, cfg, batch)
    with fsdp_gathered(_head_params(params, cfg)) as p:
        loss = chunked_ce_loss(h, _head_matrix(p, cfg), batch["labels"],
                               cfg)
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


def _serve_plan(cfg: ModelConfig, batch: int):
    """The serve plan of the ambient mesh at the global ``batch`` (None
    without a mesh of several ranks)."""
    return serve_plan_for(cfg, ambient_mesh(), batch)


def init_serve_state(cfg: ModelConfig, batch: int, s_max: int,
                     device=None) -> ServeState:
    """The empty cache of a global ``batch`` of ``s_max`` positions; under
    an ambient mesh of several ranks, the rank's blocks of it by
    ``cache_shardings`` (:class:`~repro_torch.distributed.data_parallel.
    ServePlan`)."""
    dev = resolve_device(device)
    plan = _serve_plan(cfg, batch)
    cut = plan.cache_shape if plan is not None else None
    return ServeState(init_cache(cfg, batch, s_max, dev, cut),
                      _position(0, dev))


@contextlib.contextmanager
def _serving(params: Pytree, cfg: ModelConfig, batch: int):
    """The serve plan of the ambient mesh inside its computing context
    (None and no context without a mesh of several ranks)."""
    plan = _serve_plan(cfg, batch)
    if plan is None:
        yield None
        return
    plan.check_params(params)
    with plan.computing(params):
        yield plan


@torch.no_grad()
def prefill(params: Pytree, cfg: ModelConfig, batch: Pytree,
            state: ServeState, backend: str = "cuda"
            ) -> Tuple[torch.Tensor, ServeState]:
    """Process the prompt; returns last-position logits [B, 1, V] (f32)
    and the state with the filled cache. Under an ambient mesh of several
    ranks ``params`` are the rank's shards and ``state`` its blocks
    (:func:`init_serve_state`); ``batch`` and the logits are the global
    batch's, the rank computing its rows."""
    rows = tree_util.tree_leaves(batch)[0].shape[0]
    with _serving(params, cfg, rows) as plan:
        if plan is not None:
            batch = plan.local_rows(batch)
        x = _embed(params, cfg, batch)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        x, cache = blocks_serve(params["blocks"], cfg, x, state.cache,
                                positions, "prefill", backend)
        logits = _logits(params, cfg, x[:, -1:], backend)
        if plan is not None:
            logits = plan.gather_rows(logits)
    return logits, ServeState(cache, _position(s, x.device))


@torch.no_grad()
def decode_step(params: Pytree, cfg: ModelConfig,
                tokens_or_embeds: torch.Tensor, state: ServeState,
                backend: str = "cuda") -> Tuple[torch.Tensor, ServeState]:
    """One decode step. tokens [B, 1] int (or [B, 1, D] embeds); returns
    logits [B, 1, V] (f32). Under an ambient mesh of several ranks, as
    :func:`prefill`: the global batch in and out."""
    with _serving(params, cfg, tokens_or_embeds.shape[0]) as plan:
        if plan is not None:
            tokens_or_embeds = plan.local_rows(tokens_or_embeds)
        if cfg.input_mode == "embeds" and tokens_or_embeds.dim() == 3:
            x = tokens_or_embeds.to(torch_dtype(cfg.compute_dtype))
        else:
            x = _embed_tokens(params, cfg, tokens_or_embeds)
        x, cache = blocks_serve(params["blocks"], cfg, x, state.cache,
                                state.pos, "decode", backend)
        logits = _logits(params, cfg, x, backend)
        if plan is not None:
            logits = plan.gather_rows(logits)
    return logits, ServeState(cache, state.pos + 1)
