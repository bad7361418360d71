"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory + hidden
mixing) blocks (Beck et al. 2024, arXiv:2405.04517).

The port of the JAX package's ``repro.models.xlstm``. Both mixers are
token-axis recurrences; the depth-axis Neural ODE (MALI) composes with
them as with every other mixer.

  * ``apply_mlstm_train`` / ``apply_slstm_train`` — the whole sequence
    (training, and the prompt at prefill with ``return_state``), in chunks
    of ``_CHUNK`` tokens carrying the recurrent state. Each chunk is one
    ``_Recompute`` call: its backward recomputes the chunk from the saved
    carry and inputs, as the JAX package's ``jax.checkpoint`` around its
    chunk body does, so a backward holds one chunk's per-token state at a
    time. ``torch.utils.checkpoint`` refuses ``torch.func`` transforms,
    under which MALI's backward runs the mixer; a ``forward`` +
    ``setup_context`` Function does not.
  * ``apply_mlstm_decode`` / ``apply_slstm_decode`` — one token against
    the ``LstmCache`` slot, written in place with no host read, so a
    decode step can be captured in a CUDA graph.

The recurrences stay plain PyTorch, as they stay plain ``jnp`` in the JAX
package (no Pallas kernel): ``_mlstm_steps`` / ``_slstm_steps`` run the
JAX package's ``_mlstm_step`` / ``_slstm_step`` over T tokens in a Python
loop where the JAX package runs ``lax.scan``. Every carry, q, k, v and
gate is float32. The mLSTM's work that does not depend on the carry (the
gate exponentials once the stabilizer m is known, the ``i * k v^T``
terms, the normalizer's denominator) is done for the whole chunk at
once, leaving five operations a token; each element is computed with the
JAX package's operations, ``log_sigmoid``, ``exp`` and the ``max(|n.q|,
1)`` denominator included. The stabilizer starts at -1e30, so the first
token's forget term ``exp(f_log + m - m_new)`` is exactly 0.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .common import dense_inits, full_inits, materialize, silu, torch_dtype

Pytree = Any

_CHUNK = 64
_M0 = -1e30          # the log-domain stabilizer's start


def _head_dims(cfg: ModelConfig) -> Tuple[int, int]:
    nh = cfg.n_heads
    return nh, cfg.d_model // nh


def _chunks(s: int, chunk: int, return_state: bool):
    """Token slices of ``min(chunk, s)``; with state, ``s`` must be a whole
    number of them (the JAX package pads the last chunk, which would move
    the final carry)."""
    c = min(chunk, s)
    if return_state and s % c:
        raise ValueError("prefill requires seq_len % chunk == 0")
    return [slice(i, min(i + c, s)) for i in range(0, s, c)]


class _Recompute(torch.autograd.Function):
    """``body(*tensors)`` (a tuple of tensors) whose backward recomputes it
    from the saved inputs and backpropagates through the recomputation:
    the JAX package's ``jax.checkpoint``. ``body`` must reach every tensor
    it depends on through its arguments."""

    @staticmethod
    def forward(body, *tensors):
        return body(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.body = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.body(*inputs)
        return (None, *torch.autograd.grad(outs, inputs, grads,
                                           allow_unused=True))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """mLSTM operates in the up-projected space: up = proj_factor * d."""
    up = int(cfg.lstm_proj_factor * cfg.d_model)
    nh = cfg.n_heads
    if up % nh:
        raise ValueError(f"mLSTM width {up} is not a multiple of "
                         f"{nh} heads")
    return up, nh, up // nh


def mlstm_inits(generator: torch.Generator, cfg: ModelConfig,
                device) -> Pytree:
    """Leaf initializers (``common.materialize``) of one mLSTM mixer;
    ``f_bias`` is float32 in any param dtype, as in the JAX package."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    up, nh, dh = _mlstm_dims(cfg)
    return {
        "w_up": dense_inits(generator, (d, 2 * up), dt, device),
        "w_q": dense_inits(generator, (up, nh * dh), dt, device, fan_in=up),
        "w_k": dense_inits(generator, (up, nh * dh), dt, device, fan_in=up),
        "w_v": dense_inits(generator, (up, nh * dh), dt, device, fan_in=up),
        "w_i": dense_inits(generator, (up, nh), dt, device, fan_in=up),
        "w_f": dense_inits(generator, (up, nh), dt, device, fan_in=up),
        # open forget gates
        "f_bias": full_inits((nh,), 3.0, torch.float32, device),
        "w_down": dense_inits(generator, (up, d), dt, device, fan_in=up),
        "out_norm": full_inits((up,), 1.0, dt, device),
    }


def init_mlstm(generator: torch.Generator, cfg: ModelConfig,
               device) -> Pytree:
    return materialize(mlstm_inits(generator, cfg, device))


def _mlstm_steps(c_mem, n_mem, m, q, k, v, i_raw, f_raw):
    """T tokens of the mLSTM recurrence from the carry (c_mem [B,H,dk,dv],
    n_mem [B,H,dk], m [B,H]); q/k/v [T,B,H,dh] and the raw gates [T,B,H],
    time-major, all float32. Returns the carry after the last token and
    h [T,B,H,dv]. Per-token operands are views from one ``unbind`` each:
    autograd takes an unbind back in one stack, where an index per token
    would zero-fill a chunk-sized gradient per token."""
    # jax.nn.log_sigmoid = -softplus(-x) = min(x, 0) - log1p(exp(-|x|))
    f_log = F.logsigmoid(f_raw)
    fm, ms = [], []
    for f_t, i_t in zip(f_log.unbind(0), i_raw.unbind(0)):   # stabilizer
        fm.append(f_t + m)
        m = torch.maximum(fm[-1], i_t)
        ms.append(m)
    m_all = torch.stack(ms)
    i_g = torch.exp(i_raw - m_all)[..., None]
    f_g = torch.exp(torch.stack(fm) - m_all)[..., None]
    ikv = i_g[..., None] * (k[..., :, None] * v[..., None, :])
    h_num, ns = [], []
    for ikv_t, ik_t, fc_t, fn_t, q_t in zip(
            ikv.unbind(0), (i_g * k).unbind(0), f_g[..., None].unbind(0),
            f_g.unbind(0), q[..., None, :].unbind(0)):       # memories
        c_mem = torch.addcmul(ikv_t, fc_t, c_mem)
        n_mem = torch.addcmul(ik_t, fn_t, n_mem)
        h_num.append(torch.matmul(q_t, c_mem))              # [B,H,1,dv]
        ns.append(n_mem)
    h_den = torch.maximum((torch.stack(ns) * q).sum(-1).abs(),
                          q.new_ones(()))
    return (c_mem, n_mem, m,
            torch.stack(h_num)[..., 0, :] / h_den[..., None])


def _mlstm_qkvif(params: Pytree, cfg: ModelConfig, u: torch.Tensor):
    """u [B,S,up] -> q, k, v [B,S,H,dh] and the raw gates [B,S,H],
    float32."""
    _, nh, dh = _mlstm_dims(cfg)
    b, s, _ = u.shape
    scale = dh ** -0.5
    q = (u @ params["w_q"]).reshape(b, s, nh, dh).float() * scale
    k = (u @ params["w_k"]).reshape(b, s, nh, dh).float() * scale
    v = (u @ params["w_v"]).reshape(b, s, nh, dh).float()
    i_raw = (u @ params["w_i"]).float()
    f_raw = (u @ params["w_f"]).float() + params["f_bias"]
    return q, k, v, i_raw, f_raw


def _mlstm_out(params: Pytree, h: torch.Tensor, gate: torch.Tensor,
               dtype) -> torch.Tensor:
    return (h.to(dtype) * params["out_norm"] * silu(gate)) @ params["w_down"]


def apply_mlstm_train(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                      chunk: int = _CHUNK, return_state: bool = False):
    """x [B,S,D] -> [B,S,D] (+ the final carry (C, n, m) if asked, which
    needs S to be a whole number of chunks). Differentiable."""
    b, s, _ = x.shape
    _, nh, dh = _mlstm_dims(cfg)
    u, gate = torch.chunk(x @ params["w_up"], 2, dim=-1)
    seqs = [a.transpose(0, 1).contiguous()
            for a in _mlstm_qkvif(params, cfg, u)]
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((b, nh, dh, dh), **f32),
             torch.zeros((b, nh, dh), **f32),
             torch.full((b, nh), _M0, **f32))
    hs = []
    for cs in _chunks(s, chunk, return_state):
        *carry, h = _Recompute.apply(_mlstm_steps, *carry,
                                     *(a[cs] for a in seqs))
        hs.append(h)
    h = torch.cat(hs).transpose(0, 1).reshape(b, s, nh * dh)
    out = _mlstm_out(params, h, gate, x.dtype)
    if return_state:
        return out, tuple(carry)
    return out


class LstmCache(NamedTuple):
    c: torch.Tensor   # mLSTM: [n_slots,B,H,dk,dv]; sLSTM: [n_slots,B,H,dh]
    n: torch.Tensor
    m: torch.Tensor   # [n_slots, B, H]
    h: torch.Tensor   # sLSTM hidden (zeros-shaped for mLSTM)

    @staticmethod
    def _filled(shapes, device, cut) -> "LstmCache":
        """(c, n, m, h) of the whole ``shapes``; ``cut(field, shape)``
        gives a rank's block (a serve plan's ``cache_shape``: the rows of
        a data split)."""
        f32 = dict(dtype=torch.float32, device=device)
        if cut is not None:
            shapes = [cut(f, s) for f, s in zip(LstmCache._fields, shapes)]
        c, n, m, h = shapes
        return LstmCache(torch.zeros(c, **f32), torch.zeros(n, **f32),
                         torch.full(m, _M0, **f32), torch.zeros(h, **f32))

    @staticmethod
    def init_mlstm(cfg: ModelConfig, n_slots: int, batch: int,
                   device, cut=None) -> "LstmCache":
        _, nh, dh = _mlstm_dims(cfg)
        return LstmCache._filled(
            [(n_slots, batch, nh, dh, dh), (n_slots, batch, nh, dh),
             (n_slots, batch, nh), (n_slots, batch, 1)], device, cut)

    @staticmethod
    def init_slstm(cfg: ModelConfig, n_slots: int, batch: int,
                   device, cut=None) -> "LstmCache":
        nh, dh = _head_dims(cfg)
        return LstmCache._filled(
            [(n_slots, batch, nh, dh), (n_slots, batch, nh, dh),
             (n_slots, batch, nh), (n_slots, batch, nh, dh)], device, cut)


def apply_mlstm_decode(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                       cache: LstmCache, slot: int
                       ) -> Tuple[torch.Tensor, LstmCache]:
    """x [B,1,D]: one token; writes (C, n, m) at ``slot`` in place."""
    b = x.shape[0]
    u, gate = torch.chunk(x[:, 0] @ params["w_up"], 2, dim=-1)
    seqs = [a.transpose(0, 1) for a in _mlstm_qkvif(params, cfg, u[:, None])]
    *carry, h = _mlstm_steps(cache.c[slot], cache.n[slot], cache.m[slot],
                             *seqs)
    out = _mlstm_out(params, h[0].reshape(b, -1), gate, x.dtype)[:, None]
    for buf, val in zip(cache, carry):
        buf[slot] = val
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_inits(generator: torch.Generator, cfg: ModelConfig,
                device) -> Pytree:
    """Leaf initializers of one sLSTM mixer; ``r_in`` and ``bias`` are
    float32 in any param dtype, as in the JAX package."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    nh, dh = _head_dims(cfg)
    return {
        # input projections for (z, i, f, o) gates
        "w_in": dense_inits(generator, (d, 4 * d), dt, device),
        # block-diagonal recurrent mixing per head (z, i, f, o)
        "r_in": dense_inits(generator, (4, nh, dh, dh), torch.float32,
                            device, fan_in=dh),
        "bias": full_inits((4 * d,), 0.0, torch.float32, device),
        "w_down": dense_inits(generator, (d, d), dt, device),
        "out_norm": full_inits((d,), 1.0, dt, device),
    }


def init_slstm(generator: torch.Generator, cfg: ModelConfig,
               device) -> Pytree:
    return materialize(slstm_inits(generator, cfg, device))


def _slstm_steps(r_in, bias, c_mem, n_mem, m, h, pre):
    """T tokens of the sLSTM recurrence from the carry (c_mem, n_mem, h
    [B,H,dh], m [B,H], float32); pre [T,B,4d] (x @ w_in, time-major).
    Returns the carry after the last token and h [T,B,H,dh]. The loop
    runs head-major ([H, B, ...]), so the recurrent term of all four gates
    and the input term are one batched product a token: p = (x + bias) +
    h r, with r[h, j, g*dh + i] = r_in[g, h, i, j] (the JAX package adds
    x + h r, then the bias)."""
    _, nh, dh, _ = r_in.shape
    t_len, b = pre.shape[:2]
    r = r_in.permute(1, 3, 0, 2).reshape(nh, dh, 4 * dh)
    xb = (pre.float().view(t_len, b, 4, nh, dh) + bias.view(4, nh, dh))
    xb = xb.permute(0, 3, 1, 2, 4).reshape(t_len, nh, b, 4 * dh)
    c_mem, n_mem, h = (a.transpose(0, 1) for a in (c_mem, n_mem, h))
    m = m.transpose(0, 1)[..., None]                         # [H, B, 1]
    one = xb.new_ones(())
    hs = []
    for xb_t in xb.unbind(0):
        z_t, i_t, f_t, o_t = torch.baddbmm(xb_t, h, r).view(
            nh, b, 4, dh).unbind(2)
        i_raw = i_t.mean(-1, keepdim=True)                  # per-head gates
        fm = F.logsigmoid(f_t.mean(-1, keepdim=True)) + m
        m = torch.maximum(fm, i_raw)
        i_g = torch.exp(i_raw - m)
        f_g = torch.exp(fm - m)
        c_mem = torch.addcmul(i_g * torch.tanh(z_t), f_g, c_mem)
        n_mem = torch.addcmul(i_g, f_g, n_mem)
        h = torch.sigmoid(o_t) * c_mem / torch.maximum(n_mem, one)
        hs.append(h)
    return (*(a.transpose(0, 1) for a in (c_mem, n_mem, m[..., 0], h)),
            torch.stack(hs).transpose(1, 2))


def apply_slstm_train(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                      chunk: int = _CHUNK, return_state: bool = False):
    """x [B,S,D] -> [B,S,D] (+ the final carry (c, n, m, h) if asked, which
    needs S to be a whole number of chunks). Differentiable."""
    b, s, d = x.shape
    nh, dh = _head_dims(cfg)
    pre = (x @ params["w_in"]).transpose(0, 1)               # [S, B, 4d]
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((b, nh, dh), **f32),
             torch.zeros((b, nh, dh), **f32),
             torch.full((b, nh), _M0, **f32),
             torch.zeros((b, nh, dh), **f32))
    hs = []
    for cs in _chunks(s, chunk, return_state):
        *carry, h = _Recompute.apply(_slstm_steps, params["r_in"],
                                     params["bias"], *carry, pre[cs])
        hs.append(h)
    h = torch.cat(hs).transpose(0, 1).reshape(b, s, d)
    out = (h.to(x.dtype) * params["out_norm"]) @ params["w_down"]
    if return_state:
        return out, tuple(carry)
    return out


def apply_slstm_decode(params: Pytree, cfg: ModelConfig, x: torch.Tensor,
                       cache: LstmCache, slot: int
                       ) -> Tuple[torch.Tensor, LstmCache]:
    """x [B,1,D]: one token; writes (c, n, m, h) at ``slot`` in place."""
    b = x.shape[0]
    pre = (x[:, 0] @ params["w_in"])[None]
    *carry, h = _slstm_steps(params["r_in"], params["bias"],
                             *(buf[slot] for buf in cache), pre)
    out = ((h[0].reshape(b, -1).to(x.dtype) * params["out_norm"])
           @ params["w_down"])[:, None]
    for buf, val in zip(cache, carry):
        buf[slot] = val
    return out, cache


__all__ = ["LstmCache", "mlstm_inits", "init_mlstm", "slstm_inits",
           "init_slstm", "apply_mlstm_train", "apply_mlstm_decode",
           "apply_slstm_train", "apply_slstm_decode"]
