"""The training paths of the port's model modules on the CPU against the
JAX package: the FA2-style attention Function, ``attention_train``,
``apply_mamba_train``, MoE at its training capacity (with drops),
``aux_load_balance_loss`` and ``chunked_ce_loss``.

Inputs and weights are numpy arrays from a seed, fed to both packages.
Values and gradients (``jax.vjp`` against ``torch.autograd``) are held to
max |port - jax| / max |jax| <= 1e-5 in float32 (the two packages' f32
sums in other orders; measured ~1e-7 to ~1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.lm import chunked_ce_loss as jax_chunked_ce_loss
from repro_torch import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.lm import chunked_ce_loss

torch.set_num_threads(1)

TOL = 1e-5


def _rel(port, want) -> float:
    p = np.asarray(port.detach().double().numpy() if torch.is_tensor(port)
                   else port, np.float64)
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    assert p.shape == w.shape, (p.shape, w.shape)
    return float(np.abs(p - w).max() / max(np.abs(w).max(), 1e-30))


def _close(port, want, what, tol=TOL):
    err = _rel(port, want)
    assert err <= tol, f"{what}: relative max diff {err} > {tol}"


def _np_tree(jtree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jtree)


def _grad_leaves(tree):
    """The tree with every leaf a fresh tensor that requires grad, and
    those leaves in sorted-key order (JAX's ``tree_leaves`` order)."""
    leaves = []

    def walk(node):
        out = {}
        for k in sorted(node):
            if isinstance(node[k], dict):
                out[k] = walk(node[k])
            else:
                out[k] = node[k].clone().requires_grad_()
                leaves.append(out[k])
        return out

    return walk(tree), leaves


def _close_grads(port_grads, jax_tree, what=""):
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(port_grads) == len(want)
    for a, (path, b) in zip(port_grads, want):
        _close(a, b, f"{what}d{jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# The FA2 Function
# ---------------------------------------------------------------------------

B, S, H, K, DH = 2, 40, 4, 2, 16
BLOCK_Q, BLOCK_KV = 8, 16


def _qkvg(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, DH), (B, S, K, DH), (B, S, K, DH),
                          (B, S, H, DH))]


def _attn_cfgs(cap):
    return (dataclasses.replace(jax_smoke_config("gemma2-2b"),
                                attn_softcap=cap),
            dataclasses.replace(smoke_config("gemma2-2b"), attn_softcap=cap))


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("skip", [False, True], ids=["all_tiles", "live"])
def test_flash_function_matches_jax(window, cap, skip):
    """Values and q/k/v gradients of the FA2 Function (ragged S 40 over
    8 x 16 tiles, causal) against the JAX package's
    ``_sdpa_chunked_flash`` under ``jax.vjp``; with ``live`` the masked
    tiles are skipped, which must not change anything."""
    jcfg, tcfg = _attn_cfgs(cap)
    q, k, v, g = _qkvg()
    pos = np.arange(S, dtype=np.int32)
    out, pull = jax.vjp(
        lambda q, k, v: jattn._sdpa_chunked_flash(
            jcfg, q, k, v, jnp.asarray(pos), jnp.asarray(pos), window,
            block_q=BLOCK_Q, block_kv=BLOCK_KV), q, k, v)
    jgrads = pull(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tp = torch.tensor(pos)
    tiles = (tattn._live_tiles(S, S, window, BLOCK_Q, BLOCK_KV, True)
             if skip else None)
    got = tattn._sdpa_chunked_flash(tcfg, tq, tk, tv, tp, tp, window,
                                    block_q=BLOCK_Q, block_kv=BLOCK_KV,
                                    tiles=tiles)
    _close(got, out, "out")
    tgrads = torch.autograd.grad(got, (tq, tk, tv), torch.tensor(g))
    for name, a, b in zip("qkv", tgrads, jgrads):
        _close(a, b, f"d{name}")


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_flash_function_matches_direct(window, cap):
    """The FA2 Function against the port's own ``_sdpa_direct`` (autograd
    through the full scores), values and gradients; and under
    ``torch.func.vjp``, as MALI's backward calls it, equal to autograd."""
    _, tcfg = _attn_cfgs(cap)
    q, k, v, g = _qkvg(1)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tp = torch.arange(S, dtype=torch.int32)
    tiles = tattn._live_tiles(S, S, window, BLOCK_Q, BLOCK_KV, True)
    flash = tattn._sdpa_chunked_flash(tcfg, tq, tk, tv, tp, tp, window,
                                      BLOCK_Q, BLOCK_KV, tiles)
    direct = tattn._sdpa_direct(tcfg, tq, tk, tv,
                                tattn._mask_bias(tp, tp, window))
    _close(flash, direct.detach(), "out")
    gt = torch.tensor(g)
    for a, b in zip(torch.autograd.grad(flash, (tq, tk, tv), gt),
                    torch.autograd.grad(direct, (tq, tk, tv), gt)):
        _close(a, b.numpy(), "grad")

    def f(q, k, v):
        return tattn._sdpa_chunked_flash(tcfg, q, k, v, tp, tp, window,
                                         BLOCK_Q, BLOCK_KV, tiles)

    _, pull = torch.func.vjp(f, *(t.detach() for t in (tq, tk, tv)))
    for a, b in zip(pull(gt), torch.autograd.grad(f(tq, tk, tv),
                                                  (tq, tk, tv), gt)):
        assert torch.equal(a, b)


def test_chunked_autodiff_matches_flash():
    """``attn_bwd="autodiff"`` (autograd through the tiles) gives the
    FA2 Function's values and gradients."""
    _, tcfg = _attn_cfgs(50.0)
    q, k, v, g = _qkvg(2)
    tp = torch.arange(S, dtype=torch.int32)
    outs = []
    for fn in (tattn._sdpa_chunked_flash, tattn._sdpa_chunked):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = fn(tcfg, *ts, tp, tp, 8, BLOCK_Q, BLOCK_KV)
        outs.append((o, torch.autograd.grad(o, ts, torch.tensor(g))))
    _close(outs[1][0], outs[0][0].detach().numpy(), "out")
    for a, b in zip(outs[1][1], outs[0][1]):
        _close(a, b.numpy(), "grad")


def test_live_tiles_cover_every_unmasked_pair():
    """A tile is skipped only when the mask hides it from every row."""
    for s, window in ((40, 0), (40, 8), (2100, 0), (2100, 300)):
        for bq, bk in ((8, 16), (512, 1024)):
            tiles = tattn._live_tiles(s, s, window, bq, bk, True)
            qpos = np.arange(s)[:, None]
            kpos = np.arange(s)[None, :]
            keep = kpos <= qpos
            if window:
                keep &= kpos > qpos - window
            for i in range(-(-s // bq)):
                for j in range(-(-s // bk)):
                    hit = keep[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk].any()
                    assert hit == (j in tiles[i]), (s, window, i, j)
    assert tattn._live_tiles(40, 40, 0, 8, 16, False)[0] == (0, 1, 2)


# ---------------------------------------------------------------------------
# attention_train
# ---------------------------------------------------------------------------

def _attention_case(arch, s, seed=0):
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    spec = jcfg.period[0]
    params = _np_tree(jattn.init_attention(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for name in ("q_norm", "k_norm"):
        if name in params:
            params[name]["scale"] = (1 + 0.2 * rng.standard_normal(
                params[name]["scale"].shape)).astype(np.float32)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, tcfg, spec, params, x, g


@pytest.mark.parametrize("arch,s", [("qwen3-1.7b", 24), ("gemma2-2b", 24),
                                    ("qwen3-1.7b", 2100),
                                    ("gemma2-2b", 2100)])
def test_attention_train_matches_jax(arch, s):
    """The whole training attention (projections, qk-norm, RoPE, the
    direct path at S <= 2048, the chunked FA2 path at S 2100), values and
    gradients of x and every weight."""
    jcfg, tcfg, spec, params, x, g = _attention_case(arch, s)
    out, pull = jax.vjp(
        lambda p, x: jattn.attention_train(p, jcfg, spec, x), params,
        jnp.asarray(x))
    jp, jx = pull(jnp.asarray(g))
    tp, leaves = _grad_leaves(params_from_numpy(params, device="cpu"))
    tx = torch.tensor(x, requires_grad=True)
    got = tattn.attention_train(tp, tcfg, spec, tx)
    _close(got, out, "out")
    grads = torch.autograd.grad(got, [tx] + leaves, torch.tensor(g))
    _close(grads[0], jx, "dx")
    _close_grads(grads[1:], jp)


# ---------------------------------------------------------------------------
# Mamba, MoE, the CE loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(40, 4096), (40, 16), (64, 16)])
def test_mamba_train_matches_jax(s, chunk):
    """``apply_mamba_train`` (one chunk, and 16-step chunks carrying h
    across, S a multiple and not), values and gradients."""
    jcfg = jax_smoke_config("jamba-v0.1-52b")
    tcfg = smoke_config("jamba-v0.1-52b")
    params = _np_tree(jssm.init_mamba(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(s + chunk)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    out, pull = jax.vjp(
        lambda p, x: jssm.apply_mamba_train(p, jcfg, x, chunk=chunk),
        params, jnp.asarray(x))
    jp, jx = pull(jnp.asarray(g))
    tp, leaves = _grad_leaves(params_from_numpy(params, device="cpu"))
    tx = torch.tensor(x, requires_grad=True)
    got = tssm.apply_mamba_train(tp, tcfg, tx, chunk=chunk)
    _close(got, out, "out")
    grads = torch.autograd.grad(got, [tx] + leaves, torch.tensor(g))
    _close(grads[0], jx, "dx")
    _close_grads(grads[1:], jp)


def test_mamba_train_state_matches_prefill():
    """With ``return_state`` the final (conv, ssm) state equals the serve
    path's ``apply_mamba_prefill`` (one scan op over the prompt)."""
    tcfg = smoke_config("jamba-v0.1-52b")
    jcfg = jax_smoke_config("jamba-v0.1-52b")
    params = params_from_numpy(
        _np_tree(jssm.init_mamba(jax.random.PRNGKey(1), jcfg)), device="cpu")
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32))
    out, (conv, h) = tssm.apply_mamba_train(params, tcfg, x, chunk=16,
                                            return_state=True)
    ref, (conv_r, h_r) = tssm.apply_mamba_prefill(
        params, tcfg, x, return_state=True, backend="reference")
    _close(out, ref.numpy(), "out")
    assert torch.equal(conv, conv_r)
    _close(h, h_r.numpy(), "h")
    with pytest.raises(ValueError, match="chunk"):
        tssm.apply_mamba_train(params, tcfg, x[:, :30], chunk=16,
                               return_state=True)


def _moe_case(arch, factor, seed=0):
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               moe_capacity_factor=factor)
    tcfg = dataclasses.replace(smoke_config(arch), moe_capacity_factor=factor)
    params = _np_tree(jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, tcfg, params, x, g


def _jax_routes(params, cfg, x, factor):
    """The JAX package's routes: expert ids and which (token, choice)
    pairs fit their expert's capacity, recomputed with its arithmetic."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ params["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.moe_top_k)
    eidx = np.asarray(idx).reshape(-1)
    cap = jmoe._capacity(xt.shape[0], cfg, factor)
    pos = np.zeros_like(eidx)
    seen = {}
    for i, e in enumerate(eidx):
        pos[i] = seen.get(e, 0)
        seen[e] = pos[i] + 1
    return np.asarray(idx), (pos < cap).reshape(idx.shape)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("factor", [0.5, 1.0])
def test_moe_train_capacity_matches_jax(arch, factor):
    """MoE at the training capacity factor, low enough that routes drop:
    the port's routes and drops equal the JAX package's, and the values
    and gradients (through the scatter dispatch and the gather back)
    agree."""
    jcfg, tcfg, params, x, g = _moe_case(arch, factor)
    out, pull = jax.vjp(lambda p, x: jmoe.apply_moe(p, jcfg, x), params,
                        jnp.asarray(x))
    jp, jx = pull(jnp.asarray(g))
    tp, leaves = _grad_leaves(params_from_numpy(params, device="cpu"))
    tx = torch.tensor(x, requires_grad=True)
    with tmoe.recording_routes() as log:
        got = tmoe.apply_moe(tp, tcfg, tx)
    idx, kept = _jax_routes(params, jcfg, x, factor)
    assert np.array_equal(log[0].idx.numpy(), idx)
    assert np.array_equal(log[0].kept.numpy(), kept)
    assert not kept.all(), "the case must drop routes"
    _close(got, out, "out")
    grads = torch.autograd.grad(got, [tx] + leaves, torch.tensor(g))
    _close(grads[0], jx, "dx")
    _close_grads(grads[1:], jp)


def test_moe_train_gradient_under_func_vjp():
    """MALI's backward runs the MoE under ``torch.func.vjp``: the same
    gradients as autograd."""
    _, tcfg, params, x, g = _moe_case("deepseek-moe-16b", 0.5, 1)
    tp = params_from_numpy(params, device="cpu")
    _, pull = torch.func.vjp(lambda p, x: tmoe.apply_moe(p, tcfg, x), tp,
                             torch.tensor(x))
    gp, gx = pull(torch.tensor(g))
    tp2, leaves = _grad_leaves(tp)
    tx = torch.tensor(x, requires_grad=True)
    grads = torch.autograd.grad(tmoe.apply_moe(tp2, tcfg, tx),
                                [tx] + leaves, torch.tensor(g))
    assert torch.equal(gx, grads[0])
    _, func_leaves = _grad_leaves(gp)
    assert len(func_leaves) == len(grads) - 1
    for a, b in zip(func_leaves, grads[1:]):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_aux_load_balance_loss_matches_jax(arch):
    jcfg, tcfg, params, x, _ = _moe_case(arch, 1.0, 2)
    want = jmoe.aux_load_balance_loss(params, jcfg, jnp.asarray(x))
    got = tmoe.aux_load_balance_loss(params_from_numpy(params, device="cpu"),
                                     tcfg, torch.tensor(x))
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want, "aux loss")


@pytest.mark.parametrize("s,chunk", [(40, 16), (37, 512), (64, 16)])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_chunked_ce_loss_matches_jax(s, chunk, cap):
    """Mean CE over chunks (S not a multiple of the chunk), labels -1
    masked, final softcap; value and the gradients of h and the head."""
    vocab, d = 256, 64
    jcfg = dataclasses.replace(jax_smoke_config("gemma2-2b"),
                               final_softcap=cap)
    tcfg = dataclasses.replace(smoke_config("gemma2-2b"), final_softcap=cap)
    rng = np.random.default_rng(s + chunk)
    h = rng.standard_normal((2, s, d)).astype(np.float32)
    head = (0.3 * rng.standard_normal((d, vocab))).astype(np.float32)
    labels = rng.integers(0, vocab, (2, s)).astype(np.int32)
    labels[:, ::5] = -1
    want, pull = jax.vjp(lambda h, w: jax_chunked_ce_loss(
        h, w, jnp.asarray(labels), jcfg, chunk=chunk), h, head)
    jh, jw = pull(jnp.float32(1.0))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(head, requires_grad=True)
    got = chunked_ce_loss(th, tw, torch.tensor(labels), tcfg, chunk=chunk)
    _close(got, want, "loss")
    gh, gw = torch.autograd.grad(got, (th, tw))
    _close(gh, jh, "dh")
    _close(gw, jw, "dhead")
