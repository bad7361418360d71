"""The port's xLSTM mixers (``models/xlstm.py``) and the xlstm-125m smoke
LM on the CPU against the JAX package.

The same weights feed both packages: the JAX package's ``init_mlstm`` /
``init_slstm`` / ``init_lm`` make them (every norm scale, ``out_norm``
included, redrawn with numpy around 1, so a dropped scale shows), each
leaf keeps the dtype the JAX init gives it (``r_in``, ``bias`` and
``f_bias`` stay float32 in a bfloat16 model), and the numpy tree goes to
both (``params_from_numpy`` for the port, leaf for leaf). Inputs come
from a numpy seed.

Bars: mixer and layer outputs and carries max |port - jax| / max |jax|
<= 1e-5 in float32 and 3e-2 in bfloat16; the mixers' VJPs
(``torch.func.vjp`` against ``jax.vjp``) and the LM's gradients
elementwise |port - jax| <= 2e-5 + 2e-4 |jax| (the JAX package's
MALI-vs-Naive bar); the LM loss 1e-5 relative; logits 1e-5 in float32 and
3e-2 in bfloat16; chained train steps as ``tests/test_torch_train_optim.py``
holds qwen3's (loss and gradient norm rtol 1e-5, learning rate one
float32 ulp, counters equal).

The smoke xLSTM LM amplifies rounding: with every weight moved by one
float32 rounding (relative 1e-7) the JAX package's own prefill logits move
by ~5e-5 relative with the ODE on (~1e-5 with it off), and by ~0.7 with
one bfloat16 rounding (2^-8) in bfloat16, while each layer agrees with the
JAX package's to ~1e-7 given the same input (the layer tests below). So a
whole-model result that misses its bar must lie within 3x the JAX
package's own noise floor for it, max |jax(w') - jax(w)| / max |jax(w)|,
as ``tests/test_torch_ssm_serve.py`` and ``tests/test_torch_train_moe_lm.py``
hold Jamba; in bfloat16 that says little, and the mixer and layer tests
hold the bfloat16 arithmetic.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import make_batch as jax_make_batch
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import init_serve_state as jax_init_serve_state
from repro.models.lm import lm_loss_and_stats as jax_loss_and_stats
from repro.optim import optimizer as jopt
from repro.train.loop import jitted_train_step
from repro_torch import params_from_numpy, tree_util
from repro_torch.configs import OdeSettings, smoke_config
from repro_torch.data import DataConfig, batch_to_device, make_batch
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import (decode_step, init_lm, init_serve_state,
                                lm_loss_and_stats, prefill)
from repro_torch.models import transformer as ttf
from repro_torch.models import xlstm as tx
from repro_torch.optim import optimizer as topt
from repro_torch.train import train_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "xlstm-125m"
TOL = {"f32": 1e-5, "bf16": 3e-2}
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
# one rounding of the dtype, relative: the perturbation of the noise floor
EPS = {"f32": 1e-7, "bf16": 2.0 ** -8}
FLOOR_FACTOR = 3.0
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
MODES = {"off": dict(mode="off"),
         "mali": dict(mode="per_block", method="mali", solver="alf",
                      n_steps=2),
         "naive": dict(mode="per_block", method="naive", solver="alf",
                       n_steps=2)}
B = 2
M0 = float(np.float32(-1e30))    # the stabilizer's start in float32
MIXERS = {"mlstm": (jx.init_mlstm, jx.apply_mlstm_train, tx.apply_mlstm_train,
                    jx.apply_mlstm_decode, tx.apply_mlstm_decode),
          "slstm": (jx.init_slstm, jx.apply_slstm_train, tx.apply_slstm_train,
                    jx.apply_slstm_decode, tx.apply_slstm_decode)}


def _rel(port, want) -> float:
    p = np.asarray(port.detach().float().numpy() if torch.is_tensor(port)
                   else port, np.float64)
    w = np.asarray(np.asarray(jnp.asarray(want).astype(jnp.float32)),
                   np.float64)
    assert p.shape == w.shape, (p.shape, w.shape)
    return float(np.abs(p - w).max() / max(np.abs(w).max(), 1e-30))


def _assert_close(port, want, dt, what=""):
    err = _rel(port, want)
    assert err <= TOL[dt], f"{what}: relative max diff {err} > {TOL[dt]}"


def _perturbed(np_tree, dt, seed=7):
    """Every weight times (1 + EPS[dt] * normal)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1.0 + EPS[dt] * rng.standard_normal(a.shape))
                   ).astype(np.float32), np_tree)


def _assert_within_floor(port, want, moved, tol, what=""):
    """|port - want| within max(tol, FLOOR_FACTOR x |moved - want|), all
    relative to max |want|; ``moved`` is the JAX package's result with
    perturbed weights, or a list of such results (the floor: the largest
    of their distances)."""
    err = _rel(port, want)
    floor = max(_rel(m, want) for m in
                (moved if isinstance(moved, list) else [moved]))
    bar = max(tol, FLOOR_FACTOR * floor)
    assert err <= bar, (f"{what}: relative max diff {err} > {bar} (the JAX "
                        f"package's noise floor {floor})")


def _configs(mode="mali", dt="f32"):
    jcfg = jax_smoke_config(ARCH, JaxOdeSettings(**MODES[mode]))
    tcfg = smoke_config(ARCH, OdeSettings(**MODES[mode]))
    if dt == "bf16":
        change = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
        jcfg = dataclasses.replace(jcfg, **change)
        tcfg = dataclasses.replace(tcfg, **change)
    return jcfg, tcfg


def _np_tree(params, seed=0):
    """A JAX init as writable float32 numpy with its norm scales redrawn,
    and the dtype of each leaf."""
    rng = np.random.default_rng(seed + 100)

    def leaf(path, a):
        a = np.array(a.astype(jnp.float32))
        if getattr(path[-1], "key", None) in ("scale", "out_norm"):
            a = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map(lambda a: a.dtype, params))


def _both(np_tree, dtypes):
    """The numpy tree as JAX arrays and port tensors (CPU), each leaf in
    its JAX init dtype."""
    tdt = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}
    jt = jax.tree_util.tree_map(lambda a, d: jnp.asarray(a).astype(d),
                                np_tree, dtypes)
    tt = jax.tree_util.tree_map(
        lambda a, d: params_from_numpy(a, device="cpu", dtype=tdt[d]),
        np_tree, dtypes)
    return jt, tt


def _mixer(kind, dt="f32", seed=0):
    jcfg, tcfg = _configs("mali", dt)
    init = MIXERS[kind][0]
    jp, tp = _both(*_np_tree(init(jax.random.PRNGKey(seed), jcfg), seed))
    return jcfg, tcfg, jp, tp


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _flat(tree):
    """Leaves in sorted-key order (torch's pytree keeps insertion order)."""
    return [leaf for _, leaf in sorted(
        jax.tree_util.tree_flatten_with_path(tree)[0],
        key=lambda kv: jax.tree_util.keystr(kv[0]))]


# ---------------------------------------------------------------------------
# the mixers, whole sequences (train / prefill)
# ---------------------------------------------------------------------------

CASES = [(s, chunk, state) for s in (1, 63, 64, 130) for chunk in (64, 16)
         for state in (False, True)]


def _ids(case):
    s, chunk, state = case
    return f"S{s}-chunk{chunk}-{'state' if state else 'nostate'}"


def _pads(s, chunk):
    return bool(s % min(chunk, s))


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_train_matches_jax(kind, case):
    s, chunk, state = case
    jcfg, tcfg, jp, tp = _mixer(kind)
    _, japply, tapply, _, _ = MIXERS[kind]
    x = _x((B, s, tcfg.d_model), 1)
    if state and _pads(s, chunk):
        # the JAX package refuses a padded prefill, and so does the port
        with pytest.raises(ValueError, match="seq_len % chunk"):
            japply(jp, jcfg, jnp.asarray(x), chunk=chunk, return_state=True)
        with pytest.raises(ValueError, match="seq_len % chunk"):
            tapply(tp, tcfg, torch.tensor(x), chunk=chunk, return_state=True)
        return
    want = japply(jp, jcfg, jnp.asarray(x), chunk=chunk, return_state=state)
    got = tapply(tp, tcfg, torch.tensor(x), chunk=chunk, return_state=state)
    if not state:
        want, got = (want, ()), (got, ())
    _assert_close(got[0], want[0], "f32", f"{kind} output")
    if state:
        assert len(got[1]) == len(want[1]) == (3 if kind == "mlstm" else 4)
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert a.dtype == torch.float32
        _assert_close(a, b, "f32", f"{kind} carry {i}")


VJP_CASES = [c for c in CASES if not (c[2] and _pads(c[0], c[1]))]


@pytest.mark.parametrize("case", VJP_CASES, ids=_ids)
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_train_vjp_matches_jax(kind, case):
    """d(outputs . cotangent)/d(params, x), torch.func.vjp through the
    per-chunk recompute against jax.vjp through jax.checkpoint; with
    ``return_state`` the cotangent covers the final carry too (but the
    stabilizer m, whose cotangent is 0 in any loss)."""
    s, chunk, state = case
    jcfg, tcfg, jp, tp = _mixer(kind)
    _, japply, tapply, _, _ = MIXERS[kind]
    x = _x((B, s, tcfg.d_model), 1)

    def jfn(p, xx):
        return japply(p, jcfg, xx, chunk=chunk, return_state=state)

    def tfn(p, xx):
        return tapply(p, tcfg, xx, chunk=chunk, return_state=state)

    jout, jpull = jax.vjp(jfn, jp, jnp.asarray(x))
    rng = np.random.default_rng(2)
    cot = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jout)
    if state:
        carry = list(cot[1])
        carry[2] = np.zeros_like(carry[2])
        cot = (cot[0], tuple(carry))
    jg = jpull(jax.tree_util.tree_map(jnp.asarray, cot))
    tout, tpull = tree_util.vjp(tfn, tp, torch.tensor(x))
    tg = tpull(tree_util.tree_map(torch.tensor, cot))
    _assert_close(tout[0] if state else tout,
                  jout[0] if state else jout, "f32", "output")
    names = [jax.tree_util.keystr(p) for p, _ in sorted(
        jax.tree_util.tree_flatten_with_path(jg[0])[0],
        key=lambda kv: jax.tree_util.keystr(kv[0]))]
    for name, a, b in zip(names + ["x"], _flat(tg[0]) + [tg[1]],
                          _flat(jg[0]) + [jg[1]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"{kind} d{name}", **GRAD_TOL)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_train_matches_jax_bf16(kind):
    """A bfloat16 mixer: the projections in bf16, the recurrence in f32
    (its r_in, bias, f_bias leaves stay f32)."""
    jcfg, tcfg, jp, tp = _mixer(kind, "bf16")
    _, japply, tapply, _, _ = MIXERS[kind]
    x = _x((B, 64, tcfg.d_model), 1)
    want = japply(jp, jcfg, jnp.asarray(x).astype(jnp.bfloat16),
                  return_state=True)
    got = tapply(tp, tcfg, torch.tensor(x).to(torch.bfloat16),
                 return_state=True)
    assert got[0].dtype == torch.bfloat16
    _assert_close(got[0], want[0], "bf16", f"{kind} output")
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        assert a.dtype == torch.float32
        _assert_close(a, b, "bf16", f"{kind} carry {i}")


# ---------------------------------------------------------------------------
# the cache and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(MIXERS))
def test_lstm_cache_matches_jax(kind):
    jcfg, tcfg = _configs()
    init = "init_" + kind
    want = getattr(jx.LstmCache, init)(jcfg, 3, B)
    got = getattr(tx.LstmCache, init)(tcfg, 3, B, "cpu")
    assert got._fields == want._fields == ("c", "n", "m", "h")
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(got.m.max()) == float(got.m.min()) == M0


def test_init_cache_tiles_the_stabilizer_like_jax():
    """Every period's xLSTM cache slot starts at m = -1e30, as in the JAX
    package's init_serve_state."""
    jcfg, tcfg = _configs()
    want = jax_init_serve_state(jcfg, B, 8).cache["period"]
    got = init_serve_state(tcfg, B, 8, "cpu").cache["period"]
    assert sorted(got) == sorted(want)
    for j in sorted(want):
        assert got[j]._fields == want[j]._fields
        for a, b in zip(got[j], want[j]):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", list(MIXERS))
def test_three_chained_decode_steps_match_jax(kind):
    """From a prefill's carry written into slot 1 of a 3-slot cache, three
    decode steps at that slot: outputs and every cache leaf (slots 0 and 2
    untouched)."""
    jcfg, tcfg, jp, tp = _mixer(kind)
    _, japply, tapply, jdecode, tdecode = MIXERS[kind]
    init = "init_" + kind
    x = _x((B, 16 + 3, tcfg.d_model), 3)
    _, jcarry = japply(jp, jcfg, jnp.asarray(x[:, :16]), return_state=True)
    _, tcarry = tapply(tp, tcfg, torch.tensor(x[:, :16]), return_state=True)
    jc = getattr(jx.LstmCache, init)(jcfg, 3, B)
    tc = getattr(tx.LstmCache, init)(tcfg, 3, B, "cpu")
    jc = jx.LstmCache(*(jtf._write_slot(buf, val, 1)
                        for buf, val in zip(jc, jcarry)), *jc[len(jcarry):])
    for buf, val in zip(tc, tcarry):
        buf[1] = val
    for i in range(3):
        xt = x[:, 16 + i:17 + i]
        jy, jc = jdecode(jp, jcfg, jnp.asarray(xt), jc, 1)
        ty, tc = tdecode(tp, tcfg, torch.tensor(xt), tc, 1)
        _assert_close(ty, jy, "f32", f"{kind} decode {i}")
        for name, a, b in zip(tc._fields, tc, jc):
            _assert_close(a, b, "f32", f"{kind} decode {i} cache {name}")
    assert float(tc.m[0].max()) == float(tc.m[2].max()) == M0


@pytest.mark.parametrize("kind", list(MIXERS))
def test_decode_equals_the_next_prefill_token(kind):
    """A decode step from a prefill's carry gives the output of the token
    after it in a longer prefill (63 tokens + 1 = one 64-token chunk)."""
    _, tcfg, _, tp = _mixer(kind)
    _, _, tapply, _, tdecode = MIXERS[kind]
    init = "init_" + kind
    x = torch.tensor(_x((B, 64, tcfg.d_model), 4))
    _, carry = tapply(tp, tcfg, x[:, :63], return_state=True)
    cache = getattr(tx.LstmCache, init)(tcfg, 1, B, "cpu")
    for buf, val in zip(cache, carry):
        buf[0] = val
    y, _ = tdecode(tp, tcfg, x[:, 63:], cache, 0)
    whole = tapply(tp, tcfg, x)
    assert _rel(y, whole[:, 63:].numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# the smoke LM: loss and gradients, prefill and decode, train steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lm_weights(jcfg, seed=0):
    return _np_tree(jax_init_lm(jax.random.PRNGKey(seed), jcfg), seed)


@functools.lru_cache(maxsize=None)
def _jax_vg():
    return jax.jit(jax.value_and_grad(jax_loss_and_stats, has_aux=True),
                   static_argnums=1)


def _jax_loss_grads(jcfg, w, batch):
    (loss, stats), grads = _jax_vg()(
        w, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(loss), [int(c) for c in stats],
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


@pytest.mark.parametrize("mode", list(MODES))
def test_lm_loss_and_grads_match_jax(mode):
    jcfg, tcfg = _configs(mode)
    w, _ = _lm_weights(jcfg)
    batch = make_batch(tcfg, DataConfig(seed=0, global_batch=B, seq_len=64),
                       0)
    jl, jstats, jg = _jax_loss_grads(jcfg, w, batch)
    params = params_from_numpy(w, device="cpu")
    leaves, spec = tree_util.tree_flatten(params)
    leaves = [leaf.requires_grad_() for leaf in leaves]
    tl, tstats = lm_loss_and_stats(tree_util.tree_unflatten(leaves, spec),
                                   tcfg, batch_to_device(batch, "cpu"))
    tg = [g.numpy() for g in torch.autograd.grad(tl, leaves)]
    assert abs(float(tl.detach()) - jl) <= 1e-5 * abs(jl)
    assert [int(c) for c in tstats] == jstats
    if mode != "off":
        # 12 mixer branches, no MLP: 2 accepted steps and 3 f-evals each
        assert jstats == [24, 0, 36]
    assert len(jg) == len(tg)
    moved = None
    for i, (a, b) in enumerate(zip(tg, jg)):
        if np.allclose(a, b, **GRAD_TOL):
            continue
        if moved is None:
            moved = _jax_loss_grads(jcfg, _perturbed(w, "f32"), batch)[2]
        _assert_within_floor(a, b, moved[i], 0.0, f"{mode} leaf {i}")


def test_training_step_runs_only_the_mali_alf_ops():
    """One MALI gradient through ALF(backend="cuda") (plain versions on
    the CPU): 2 calls of each of the four MALI ALF ops a branch, none of
    the three LM ops."""
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, ode=dataclasses.replace(
        tcfg.ode, backend="cuda"))
    params = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    leaves, spec = tree_util.tree_flatten(params)
    leaves = [leaf.requires_grad_() for leaf in leaves]
    batch = batch_to_device(make_batch(tcfg, DataConfig(
        seed=0, global_batch=B, seq_len=32), 0), "cpu")
    for ops in (alf_ops, fa_ops, rn_ops, scan_ops):
        ops.reset_op_calls()
    loss, _ = lm_loss_and_stats(tree_util.tree_unflatten(leaves, spec),
                                tcfg, batch)
    torch.autograd.grad(loss, leaves)
    assert {k: v for k, v in alf_ops.OP_CALLS.items() if v} == {
        "alf_midpoint": 24, "alf_update": 24, "alf_bwd_pre": 24,
        "alf_bwd_post": 24}
    assert not any(fa_ops.OP_CALLS.values())
    assert not any(rn_ops.OP_CALLS.values())
    assert not any(scan_ops.OP_CALLS.values())


def _cache_leaves(cache):
    return [(f"{j}.{name}", leaf) for j in sorted(cache["period"])
            for name, leaf in zip(cache["period"][j]._fields,
                                  cache["period"][j])]


def _jax_serve(jcfg, jw, toks, prompt, n_decode):
    """The JAX package's prefill + teacher-forced decode: (logits of each
    call, the cache leaves at the end)."""
    jdec = jax.jit(jax_make_decode_step(jcfg))
    jl, js = jax.jit(jax_make_prefill_step(jcfg))(
        jw, {"tokens": jnp.asarray(toks[:, :prompt])},
        jax_init_serve_state(jcfg, B, prompt + n_decode))
    logits = [jl]
    for i in range(n_decode):
        jl, js = jdec(jw, jnp.asarray(toks[:, prompt + i:prompt + i + 1]),
                      js)
        logits.append(jl)
    assert int(js.pos) == prompt + n_decode
    return logits, _cache_leaves(js.cache)


@pytest.mark.parametrize("ode_on", [True, False], ids=["ode", "off"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(dt, ode_on):
    """Prefill of 64 tokens and 3 decode steps: logits and every cache
    leaf, each within its bar or 3x the JAX package's noise floor."""
    prompt, n_decode = 64, 3
    jcfg, tcfg = _configs("mali" if ode_on else "off", dt)
    w, dts = _lm_weights(jcfg)
    jw, tw = _both(w, dts)
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, prompt + n_decode)).astype(np.int32)
    want = _jax_serve(jcfg, jw, toks, prompt, n_decode)
    moved = _jax_serve(jcfg, _both(_perturbed(w, dt), dts)[0], toks, prompt,
                       n_decode)
    tl, ts = prefill(tw, tcfg, {"tokens": torch.tensor(toks[:, :prompt])},
                     init_serve_state(tcfg, B, prompt + n_decode, "cpu"))
    got = [tl]
    for i in range(n_decode):
        tl, ts = decode_step(tw, tcfg, torch.tensor(
            toks[:, prompt + i:prompt + i + 1]), ts)
        got.append(tl)
    assert int(ts.pos) == prompt + n_decode
    for i, (a, b, m) in enumerate(zip(got, want[0], moved[0])):
        assert a.dtype == torch.float32 and tuple(a.shape) == (B, 1, 256)
        _assert_within_floor(a, b, m, TOL[dt], f"logits {i}")
    for (name, a), (_, b), (_, m) in zip(_cache_leaves(ts.cache), want[1],
                                         moved[1]):
        assert a.dtype == torch.float32
        _assert_within_floor(a, b, m, TOL[dt], name)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("j", [0, 5], ids=["mlstm", "slstm"])
def test_layer_serve_matches_jax(j, dt):
    """One continuous-depth layer (3 f-evals of its mixer, a cache slot
    each): a 64-token prefill from the same input, then a decode step, at
    the strict bars."""
    jcfg, tcfg = _configs("mali", dt)
    w, dts = _lm_weights(jcfg)
    pick = functools.partial(jax.tree_util.tree_map, lambda a: a[0])
    jl, tl = _both(pick(w["blocks"]["period"][f"sub{j}"]),
                   dts["blocks"]["period"][f"sub{j}"])
    spec = tcfg.period[j]
    x = _x((B, 65, tcfg.d_model), 5)
    jc = jtf.init_layer_cache(jcfg, spec, B, 65)
    tc = ttf.init_layer_cache(tcfg, spec, B, 65, "cpu")
    jx_in = jnp.asarray(x).astype(JAX_DT[dt])
    tx_in = torch.tensor(x).to(TORCH_DT[dt])
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (B, 64))
    jy, jc = jtf.layer_serve(jl, jcfg, spec, jx_in[:, :64], jc,
                             jnp.asarray(pos), "prefill")
    ty, tc = ttf.layer_serve(tl, tcfg, spec, tx_in[:, :64], tc,
                             torch.tensor(pos), "prefill")
    _assert_close(ty, jy, dt, "layer prefill")
    jy, jc = jtf.layer_serve(jl, jcfg, spec, jx_in[:, 64:], jc,
                             jnp.int32(64), "decode")
    ty, tc = ttf.layer_serve(tl, tcfg, spec, tx_in[:, 64:], tc,
                             torch.tensor(64, dtype=torch.int32), "decode")
    _assert_close(ty, jy, dt, "layer decode")
    for name, a, b in zip(tc._fields, tc, jc):
        assert a.dtype == torch.float32
        _assert_close(a, b, dt, f"cache {name}")


def test_prefill_then_decode_equals_longer_prefill():
    """prefill(63) + decode(token 63) against prefill(64): the chunk rule
    allows both lengths."""
    jcfg, tcfg = _configs()
    _, tw = _both(*_lm_weights(jcfg))
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, 64)))
    _, st = prefill(tw, tcfg, {"tokens": toks[:, :63]},
                    init_serve_state(tcfg, B, 64, "cpu"))
    a, _ = decode_step(tw, tcfg, toks[:, 63:], st)
    b, _ = prefill(tw, tcfg, {"tokens": toks},
                   init_serve_state(tcfg, B, 64, "cpu"))
    assert _rel(a, b.numpy()) <= 1e-5


def test_prefill_refuses_a_padded_prompt_like_jax():
    jcfg, tcfg = _configs()
    jw, tw = _both(*_lm_weights(jcfg))
    toks = np.zeros((B, 65), np.int32)
    with pytest.raises(ValueError, match="seq_len % chunk"):
        jax_make_prefill_step(jcfg)(jw, {"tokens": jnp.asarray(toks)},
                                    jax_init_serve_state(jcfg, B, 65))
    with pytest.raises(ValueError, match="seq_len % chunk"):
        prefill(tw, tcfg, {"tokens": torch.tensor(toks)},
                init_serve_state(tcfg, B, 65, "cpu"))


def test_op_calls_per_prefill_and_decode_step():
    """What chip_smoke.py counts for xlstm-125m, at the smoke widths: per
    prefill and per decode step one RMSNorm a mixer f-eval (12 layers x 3)
    + the final norm, one ALF midpoint and update a step and layer, no
    flash attention and no scan."""
    _, tcfg = _configs()
    tw = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    state = init_serve_state(tcfg, B, 33, "cpu")
    toks = torch.zeros((B, 33), dtype=torch.int64)
    want = {"rmsnorm": 37, "alf_midpoint": 24, "alf_update": 24,
            "flash_attention": 0, "selective_scan": 0}
    for run in (lambda st: prefill(tw, tcfg, {"tokens": toks[:, :32]}, st),
                lambda st: decode_step(tw, tcfg, toks[:, 32:], st)):
        for ops in (alf_ops, fa_ops, rn_ops, scan_ops):
            ops.reset_op_calls()
        _, state = run(state)
        got = {**rn_ops.OP_CALLS, **fa_ops.OP_CALLS, **scan_ops.OP_CALLS,
               "alf_midpoint": alf_ops.OP_CALLS["alf_midpoint"],
               "alf_update": alf_ops.OP_CALLS["alf_update"]}
        assert got == want


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_weights_keep_the_jax_packages_dtypes(dt):
    """The port's init_lm gives every leaf the JAX init's shape and dtype
    (r_in, bias and f_bias float32 in a bf16 model), and the converted
    numpy tree keeps them."""
    jcfg, tcfg = _configs("mali", dt)
    want = jax.eval_shape(lambda: jax_init_lm(jax.random.PRNGKey(0), jcfg))
    got = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    _, conv = _both(*_lm_weights(jcfg))
    tdt = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}
    jl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
    for tree in (got, conv):
        tl = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert sorted(tl) == sorted(jl)
        for key, leaf in jl.items():
            assert tuple(tl[key].shape) == leaf.shape, key
            assert tl[key].dtype == tdt[leaf.dtype], key
    f32 = [k for k, v in jl.items() if v.dtype == jnp.float32]
    assert any("r_in" in k for k in f32) and any("f_bias" in k for k in f32)


def _jax_chain(jcfg, w, jc, dcfg, n):
    """n jitted_train_steps from weights ``w``: each step's metrics."""
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    js, out = jopt.init_opt_state(jc, jp), []
    for step in range(n):
        jbatch = jax_make_batch(jcfg, JaxDataConfig(**dcfg), step)
        jp, js, _, jm = jitted_train_step(
            jp, js, None, {k: jnp.asarray(v) for k, v in jbatch.items()},
            cfg=jcfg, opt_cfg=jc)
        out.append(jm)
    return out


def test_chained_train_steps_match_jitted_train_step():
    """Three train_steps against the JAX package's jitted_train_step
    (MALI, 2 ALF steps, AdamW): loss and gradient norm rtol 1e-5 or within
    3x the JAX package's own noise floor, learning rate within a float32
    ulp, counters equal. After the first AdamW update the floor depends on
    the draw of the perturbation (from 7e-5 to 2e-2 relative on the
    gradient norm of step 1 over three draws: a parameter whose gradient
    is near 0 moves by +-lr whatever its size), so it is the largest over
    three draws."""
    n = 3
    jcfg, tcfg = _configs()
    w, _ = _lm_weights(jcfg, seed=3)
    jc = jopt.OptimizerConfig(warmup_steps=1, total_steps=n)
    tc = topt.OptimizerConfig(warmup_steps=1, total_steps=n)
    dcfg = dict(seed=5, global_batch=B, seq_len=32)
    want = _jax_chain(jcfg, w, jc, dcfg, n)
    moved = [_jax_chain(jcfg, _perturbed(w, "f32", seed), jc, dcfg, n)
             for seed in (7, 8, 9)]
    tp = params_from_numpy(w, device="cpu")
    ts = topt.init_opt_state(tc, tp)
    for step, jm in enumerate(want):
        batch = make_batch(tcfg, DataConfig(**dcfg), step)
        for k, v in jax_make_batch(jcfg, JaxDataConfig(**dcfg), step).items():
            assert np.array_equal(batch[k], v)
        tp, ts, _, tm = train_step(tp, ts, None,
                                   batch_to_device(batch, "cpu"),
                                   cfg=tcfg, opt_cfg=tc)
        for key in ("loss", "grad_norm"):
            _assert_within_floor(tm[key], jm[key],
                                 [m[step][key] for m in moved], 1e-5,
                                 f"{key} step {step}")
        lr, jlr = np.float32(tm["lr"]), np.float32(jm["lr"])
        assert abs(lr - jlr) <= np.spacing(np.abs(jlr)), (lr, jlr)
        for key in ("ode_accepted", "ode_rejected", "ode_fevals"):
            assert int(tm[key]) == int(jm[key]), key


# ---------------------------------------------------------------------------
# the launchers on the CPU
# ---------------------------------------------------------------------------

def _cli(*args):
    # one thread: the suite may run in several worker processes at once
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", *args], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_serve_cli_runs_xlstm_on_the_cpu():
    res = _cli("repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
               "--prompt-len", "64", "--decode-tokens", "4", "--batch", "2")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "arch=xlstm-125m-smoke batch=2 prompt=64" in res.stdout


def test_train_cli_runs_xlstm_on_the_cpu():
    res = _cli("repro_torch.launch.train", "--arch", ARCH, "--device", "cpu",
               "--steps", "2", "--global-batch", "2", "--seq-len", "32")
    assert res.returncode == 0, res.stderr[-2000:]
    assert "final_step=2" in res.stdout
