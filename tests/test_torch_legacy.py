"""The port's two legacy leftovers on the CPU, held to the JAX package:
``repro_torch.core``'s deprecated ``integrate_fixed_grid`` /
``integrate_adaptive_grid`` (thin wrappers of ``integrate_grid``) on one
seeded problem each, and ``launch/train.py``'s ``TrainConfig`` /
``train`` (delegators onto ``TrainerConfig``) on a short smoke-config
run against the JAX package's ``jitted_train_step`` from the same
weights (the JAX ``Trainer`` is no oracle here: its mesh path fails
under this jax, as ``tests/test_torch_trainer.py`` notes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import integrate_adaptive_grid as jax_adaptive_grid
from repro.core import integrate_fixed_grid as jax_fixed_grid
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import make_batch as jax_make_batch
from repro.launch.train import TrainConfig as JaxTrainConfig
from repro.launch.train import _to_trainer_config as jax_to_trainer_config
from repro.optim import optimizer as jopt
from repro.train.loop import jitted_train_step
from repro_torch import tree_util
from repro_torch.core import integrate_adaptive_grid, integrate_fixed_grid
from repro_torch.launch.train import TrainConfig, _to_trainer_config, train
from repro_torch.train import MemoryEmitter

torch.set_num_threads(1)

D, T = 3, 5


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    w = (0.8 * rng.standard_normal((D, D))).astype(np.float32)
    b = (0.3 * rng.standard_normal(D)).astype(np.float32)
    z0 = rng.standard_normal(D).astype(np.float32)
    ts = np.linspace(0.0, 1.5, T).astype(np.float32)
    return w, b, z0, ts


def _f(np_mod, w, b):
    def f(z, t):
        return np_mod.tanh(z @ w) + t * b
    return f


def test_integrate_fixed_grid_matches_jax():
    w, b, z0, ts = _problem()
    jf = _f(jnp, jnp.asarray(w), jnp.asarray(b))
    tf = _f(torch, torch.as_tensor(w), torch.as_tensor(b))
    jstate, jtraj = jax_fixed_grid(lambda s, t, h: s + h * jf(s, t),
                                   jnp.asarray(z0), jnp.asarray(ts), 4)
    state, traj = integrate_fixed_grid(lambda s, t, h: s + h * tf(s, t),
                                       torch.as_tensor(z0),
                                       torch.as_tensor(ts), 4)
    assert traj.shape == (T, D)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj),
                               rtol=1e-6, atol=1e-6)


def _heun_euler(np_mod, f, rtol=1e-3, atol=1e-4):
    """A Heun-Euler trial: (the Heun step, its RMS error ratio)."""
    def trial(s, t, h):
        k1 = f(s, t)
        y1 = s + h * k1
        y2 = s + 0.5 * h * (k1 + f(y1, t + h))
        scale = atol + rtol * np_mod.maximum(np_mod.abs(s), np_mod.abs(y2))
        return y2, np_mod.sqrt(np_mod.mean(((y2 - y1) / scale) ** 2))
    return trial


def test_integrate_adaptive_grid_matches_jax():
    w, b, z0, ts = _problem(1)
    kw = dict(order=2, rtol=1e-3, atol=1e-4, max_steps=64)
    jres = jax_adaptive_grid(
        _heun_euler(jnp, _f(jnp, jnp.asarray(w), jnp.asarray(b))),
        jnp.asarray(z0), jnp.asarray(ts), **kw)
    res = integrate_adaptive_grid(
        _heun_euler(torch, _f(torch, torch.as_tensor(w),
                              torch.as_tensor(b))),
        torch.as_tensor(z0), torch.as_tensor(ts), **kw)
    assert res.n_accepted.tolist() == np.asarray(jres.n_accepted).tolist()
    assert int(res.n_trials) == int(jres.n_trials)
    assert bool(res.completed) and bool(jres.completed)
    np.testing.assert_allclose(res.traj.numpy(), np.asarray(jres.traj),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.hs.numpy(), np.asarray(jres.hs),
                               rtol=1e-4, atol=1e-7)


def test_train_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours.pop("device") == ""
    assert ours == theirs
    tc = TrainConfig(arch="stablelm-1.6b", steps=7, compress=True, seed=3)
    jtc = JaxTrainConfig(arch="stablelm-1.6b", steps=7, compress=True, seed=3)
    mine, want = _to_trainer_config(tc), jax_to_trainer_config(jtc)
    for f in dataclasses.fields(want):
        assert getattr(mine, f.name) == getattr(want, f.name), f.name


def test_legacy_train_matches_jitted_train_step():
    tc = TrainConfig(steps=3, global_batch=4, seq_len=16, log_every=100,
                     device="cpu")
    emitter = MemoryEmitter()
    assert train(tc, emitter=emitter) == 3
    losses = [r.loss for r in emitter.records]
    assert len(losses) == 3

    # the JAX package's step chain from the Trainer's seeded weights
    from repro_torch.models import init_lm
    from repro_torch.train.trainer import build
    cfg, _, _ = build(_to_trainer_config(tc))
    weights = init_lm(torch.Generator().manual_seed(tc.seed), cfg, "cpu")
    jtc = jax_to_trainer_config(JaxTrainConfig(
        steps=3, global_batch=4, seq_len=16, log_every=100))
    jcfg = jax_smoke_config(jtc.arch, jtc.ode_settings())
    jp = jax.tree_util.tree_map(
        jnp.asarray, tree_util.tree_map(lambda t: t.numpy(), weights))
    jc = jopt.OptimizerConfig(total_steps=3, warmup_steps=1)
    js = jopt.init_opt_state(jc, jp)
    for step in range(3):
        batch = jax_make_batch(jcfg, JaxDataConfig(seed=tc.seed,
                                                   global_batch=4,
                                                   seq_len=16), step)
        jp, js, _, jm = jitted_train_step(
            jp, js, None, {k: jnp.asarray(v) for k, v in batch.items()},
            cfg=jcfg, opt_cfg=jc)
        assert losses[step] == pytest.approx(float(jm["loss"]), rel=1e-5)
