"""The port's optimizers, gradient compression and train step on the CPU
against the JAX package: ``lr_schedule``, ``clip_by_global_norm``,
``apply_updates`` (AdamW with bf16 moments and a float32 master copy,
AdamW without a master copy, SGD with momentum), ``compress_grads`` and
three chained ``train_step``s (standard, two microbatches, compressed)
against the JAX package's ``jitted_train_step`` without a mesh.

Bars: a float32 result within 1e-6 relative of the JAX package's, or one
float32 ulp; a bfloat16 result within one bfloat16 ulp (the two
packages' float32 values may straddle a rounding boundary); int8 codes
equal. The train steps are held on their loss (rtol 1e-5), learning rate
(one float32 ulp), gradient norm (rtol 1e-5: it sums gradients that agree
to ~1e-7, not bit for bit) and counters (equal); their parameters are not
compared element by element, since an AdamW step moves a parameter whose
gradient is near 0 by +-lr whatever the gradient's size, so a 1e-7
difference there can flip the step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import make_batch as jax_make_batch
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro.train.loop import jitted_train_step
from repro_torch import params_from_numpy
from repro_torch import tree_util
from repro_torch.configs import OdeSettings, smoke_config
from repro_torch.data import DataConfig, batch_to_device, make_batch
from repro_torch.launch.steps import make_loss_fn, make_train_step
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizer as topt
from repro_torch.train import train_step

from test_torch_train_lm import MODES, np_weights

torch.set_num_threads(1)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_ulp_close(port, want, dtype, what=""):
    """|port - want| <= max(1e-6 |want|, one ulp of ``dtype`` at want)."""
    p, w = _np(port), _np(want)
    assert p.shape == w.shape, (what, p.shape, w.shape)
    ulp = np.spacing(np.abs(w).astype(np.float32))
    if dtype == "bfloat16":
        ulp = ulp * 2.0 ** 16          # 8 mantissa bits against 24
    bound = np.maximum(1e-6 * np.abs(w), ulp)
    bad = np.abs(p - w) > bound
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} beyond the "
                           f"bound; max diff {np.abs(p - w).max()}")


def _grads_tree(seed, scale=1.0):
    """A small nested gradient tree (sorted keys), float32 numpy."""
    rng = np.random.default_rng(seed)
    w = scale * rng.standard_normal((7, 5)).astype(np.float32)
    b = scale * rng.standard_normal((5,)).astype(np.float32)
    return {"a": {"b": b, "w": w},
            "z": [scale * rng.standard_normal((3, 4)).astype(np.float32)]}


def _to_jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype),
                                  tree)


def _to_torch(tree, dtype):
    return params_from_numpy(tree, device="cpu", dtype=dtype)


def _pairs(port_tree, jax_tree):
    return zip(tree_util.tree_leaves(port_tree),
               jax.tree_util.tree_leaves(jax_tree))


@pytest.mark.parametrize("warmup,total", [(1, 3), (100, 10000), (5, 40)])
def test_lr_schedule_matches_jax(warmup, total):
    jc = jopt.OptimizerConfig(warmup_steps=warmup, total_steps=total)
    tc = topt.OptimizerConfig(warmup_steps=warmup, total_steps=total)
    for step in sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 3}):
        if step < 0:
            continue
        got = topt.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
        want = jopt.lr_schedule(jc, jnp.int32(step))
        assert got.dtype == torch.float32 and got.shape == ()
        assert_ulp_close(got, want, "float32", f"lr at {step}")


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (0.01, 1.0),
                                            (1.0, 0.0)])
def test_clip_by_global_norm_matches_jax(scale, max_norm):
    g = _grads_tree(0, scale)
    tg, tn = topt.clip_by_global_norm(_to_torch(g, torch.float32), max_norm)
    jg, jn = jopt.clip_by_global_norm(_to_jax(g, jnp.float32), max_norm)
    assert_ulp_close(tn, jn, "float32", "norm")
    for a, b in _pairs(tg, jg):
        assert_ulp_close(a, b, "float32", "clipped")


OPT_CASES = {
    "adamw_bf16_master": (dict(), "bfloat16"),
    "adamw_f32_params": (dict(), "float32"),
    "adamw_no_master": (dict(master_dtype=""), "float32"),
    "adamw_f32_moments": (dict(momentum_dtype="float32"), "bfloat16"),
    "sgd": (dict(name="sgd"), "float32"),
    "sgd_bf16": (dict(name="sgd", master_dtype=""), "bfloat16"),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_apply_updates_matches_jax(case):
    """Three updates with the same numpy gradients fed to each package's
    own state; parameters, moments, master copy, step, lr and grad norm
    after each."""
    kw, pdt = OPT_CASES[case]
    jc = jopt.OptimizerConfig(warmup_steps=2, total_steps=6, **kw)
    tc = topt.OptimizerConfig(warmup_steps=2, total_steps=6, **kw)
    params = _grads_tree(1)
    jp = _to_jax(params, jnp.dtype(pdt))
    tp = _to_torch(params, getattr(torch, pdt))
    js, ts = jopt.init_opt_state(jc, jp), topt.init_opt_state(tc, tp)
    mdt = tc.momentum_dtype
    for step in range(3):
        g = _grads_tree(10 + step, 0.3)
        jp, js, jm = jopt.apply_updates(jc, jp, _to_jax(g, jnp.dtype(pdt)),
                                        js)
        tp, ts, tm = topt.apply_updates(tc, tp, _to_torch(
            g, getattr(torch, pdt)), ts)
        assert int(ts.step) == int(js.step) == step + 1
        assert_ulp_close(tm["lr"], jm["lr"], "float32", "lr")
        assert_ulp_close(tm["grad_norm"], jm["grad_norm"], "float32", "norm")
        for a, b in _pairs(tp, jp):
            assert a.dtype == getattr(torch, pdt)
            assert_ulp_close(a, b, pdt, f"{case} params step {step}")
        for name, dt in (("m", mdt), ("v", mdt), ("master", "float32")):
            for a, b in _pairs(getattr(ts, name), getattr(js, name)):
                assert tuple(a.shape) == tuple(b.shape)
                if a.numel():
                    assert_ulp_close(a, b, dt, f"{case} {name} step {step}")


def test_quantize_and_compress_match_jax():
    g = _grads_tree(3)
    g["a"]["w"][0, 0] = 0.0
    g["z"][0][1] *= 1e3             # a leaf with a wide range
    for leaf in (g["a"]["w"], g["z"][0]):
        q, s = tcomp.quantize_int8(torch.tensor(leaf))
        jq, js = jcomp.quantize_int8(jnp.asarray(leaf))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        assert torch.equal(tcomp.dequantize_int8(q, s),
                           torch.tensor(np.asarray(
                               jcomp.dequantize_int8(jq, js))))
    tef = tcomp.init_ef_state(_to_torch(g, torch.float32))
    jef = jcomp.init_ef_state(_to_jax(g, jnp.float32))
    for step in range(3):
        step_g = _grads_tree(20 + step)
        tdeq, tef = tcomp.compress_grads(_to_torch(step_g, torch.float32),
                                         tef)
        jdeq, jef = jcomp.compress_grads(_to_jax(step_g, jnp.float32), jef)
        for a, b in _pairs(tdeq, jdeq):
            assert_ulp_close(a, b, "float32", "dequantized")
        for a, b in _pairs(tef.error, jef.error):
            assert_ulp_close(a, b, "float32", "error feedback")
    assert tcomp.compressed_bytes(_to_torch(g, torch.float32)) == \
        jcomp.compressed_bytes(_to_jax(g, jnp.float32))


# ---------------------------------------------------------------------------
# Chained train steps
# ---------------------------------------------------------------------------

STEP_CASES = {"standard": dict(microbatches=1, compress=False),
              "microbatches2": dict(microbatches=2, compress=False),
              "compressed": dict(microbatches=1, compress=True)}
N_STEPS = 3


@functools.lru_cache(maxsize=None)
def _step_setup():
    jcfg = jax_smoke_config("qwen3-1.7b", JaxOdeSettings(**MODES["mali"]))
    tcfg = smoke_config("qwen3-1.7b", OdeSettings(**MODES["mali"]))
    return jcfg, tcfg, np_weights(jcfg, seed=3)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_chained_train_steps_match_jitted_train_step(case):
    kw = STEP_CASES[case]
    jcfg, tcfg, w = _step_setup()
    jc = jopt.OptimizerConfig(warmup_steps=1, total_steps=N_STEPS)
    tc = topt.OptimizerConfig(warmup_steps=1, total_steps=N_STEPS)
    jp = _to_jax(w, jnp.float32)
    tp = _to_torch(w, torch.float32)
    js, ts = jopt.init_opt_state(jc, jp), topt.init_opt_state(tc, tp)
    jef = jcomp.init_ef_state(jp) if kw["compress"] else None
    tef = tcomp.init_ef_state(tp) if kw["compress"] else None
    dcfg = dict(seed=5, global_batch=4, seq_len=16)
    for step in range(N_STEPS):
        batch = make_batch(tcfg, DataConfig(**dcfg), step)
        jbatch = jax_make_batch(jcfg, JaxDataConfig(**dcfg), step)
        for k in batch:
            assert np.array_equal(batch[k], jbatch[k])
        jp, js, jef, jm = jitted_train_step(
            jp, js, jef, {k: jnp.asarray(v) for k, v in jbatch.items()},
            cfg=jcfg, opt_cfg=jc, **kw)
        tp, ts, tef, tm = train_step(tp, ts, tef,
                                     batch_to_device(batch, "cpu"),
                                     cfg=tcfg, opt_cfg=tc, **kw)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"loss step {step}")
        assert_ulp_close(tm["lr"], jm["lr"], "float32", f"lr step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        for key in ("ode_accepted", "ode_rejected", "ode_fevals"):
            assert int(tm[key]) == int(jm[key]), key
        assert int(ts.step) == int(js.step) == step + 1
    assert (tef is None) == (not kw["compress"])


def test_step_factories_match_train_step():
    """``launch.steps``' closures compute what ``train_step`` does."""
    _, tcfg, w = _step_setup()
    tc = topt.OptimizerConfig(warmup_steps=1, total_steps=2)
    batch = batch_to_device(make_batch(tcfg, DataConfig(global_batch=2,
                                                        seq_len=8), 0), "cpu")
    loss = make_loss_fn(tcfg)(_to_torch(w, torch.float32), batch)
    tp = _to_torch(w, torch.float32)
    _, _, _, m = train_step(tp, topt.init_opt_state(tc, tp), None, batch,
                            cfg=tcfg, opt_cfg=tc)
    assert torch.equal(loss.detach(), m["loss"])
    for compress in (False, True):
        step = make_train_step(tcfg, tc, compress=compress)
        tp = _to_torch(w, torch.float32)
        state = topt.init_opt_state(tc, tp)
        if compress:
            p2, _, ef, m2 = step(tp, state, tcomp.init_ef_state(tp), batch)
            assert ef is not None
        else:
            p2, _, m2 = step(tp, state, batch)
        assert torch.equal(m2["loss"], m["loss"])
        assert len(tree_util.tree_leaves(p2)) == len(tree_util.tree_leaves(tp))
