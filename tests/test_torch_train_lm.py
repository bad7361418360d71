"""The port's LM training loss (``lm_loss_and_stats``) and its gradient on
the CPU against the JAX package's ``jax.value_and_grad``, for the dense
smoke configs: qwen3 (GQA, qk-norm), gemma2 (window, softcaps, tied
embeddings), stablelm (MHA) and granite (MQA), each with the ODE off and
with every residual branch a MALI or a Naive solve (ALF, 2 steps,
reference backend), float32.

Weights come from the JAX package's ``init_lm`` with every norm scale
redrawn around 1; the batch is ``make_batch``'s (bit-equal in both
packages). Bars: loss max |port - jax| / |jax| <= 1e-5; every gradient
leaf elementwise |port - jax| <= 2e-5 + 2e-4 |jax| (the gradient bar of
the JAX package's MALI-vs-Naive tests); the ODE counters equal. Also:
MALI against Naive inside the port (``tests/test_train.py``'s check), and
that a training step runs none of the three LM ops (RMSNorm, flash
attention, the scan) and exactly the four MALI ALF ops a branch-step
(counted through ``ALF(backend="cuda")``, whose ops take their plain
versions on the CPU).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import lm_loss_and_stats as jax_loss_and_stats
from repro_torch import params_from_numpy
from repro_torch import tree_util
from repro_torch.configs import OdeSettings, smoke_config
from repro_torch.data import DataConfig, batch_to_device, make_batch
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import init_lm, lm_loss, lm_loss_and_stats

torch.set_num_threads(1)

LOSS_TOL = 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
MODES = {"off": dict(mode="off"),
         "mali": dict(mode="per_block", method="mali", solver="alf",
                      n_steps=2),
         "naive": dict(mode="per_block", method="naive", solver="alf",
                       n_steps=2)}
DENSE_ARCHS = ["qwen3-1.7b", "gemma2-2b", "stablelm-1.6b", "granite-20b"]
B, S = 2, 16


def np_weights(jcfg, seed=0):
    """The JAX package's init as f32 numpy, every norm scale redrawn."""
    rng = np.random.default_rng(seed + 100)
    params = jax_init_lm(jax.random.PRNGKey(seed), jcfg)

    def leaf(path, a):
        a = np.array(a, np.float32)
        if getattr(path[-1], "key", None) == "scale":
            a = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def np_batch(tcfg, seed=0):
    return make_batch(tcfg, DataConfig(seed=seed, global_batch=B,
                                       seq_len=S), 0)


@functools.lru_cache(maxsize=None)
def _jax_vg():
    return jax.jit(jax.value_and_grad(jax_loss_and_stats, has_aux=True),
                   static_argnums=1)


def jax_loss_grads(jcfg, weights, batch):
    (loss, stats), grads = _jax_vg()(
        weights, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return (float(loss), [int(c) for c in stats],
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def port_loss_grads(tcfg, weights, batch):
    params = params_from_numpy(weights, device="cpu")
    leaves, spec = tree_util.tree_flatten(params)
    leaves = [leaf.requires_grad_() for leaf in leaves]
    loss, stats = lm_loss_and_stats(tree_util.tree_unflatten(leaves, spec),
                                    tcfg, batch_to_device(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [np.zeros(tuple(p.shape), np.float32) if g is None
             else g.numpy() for p, g in zip(leaves, grads)]
    return float(loss.detach()), [int(c) for c in stats], grads


def configs(arch, mode, **changes):
    jcfg = jax_smoke_config(arch, JaxOdeSettings(**MODES[mode]))
    tcfg = smoke_config(arch, OdeSettings(**MODES[mode]))
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(tcfg, **changes))


def assert_grads_close(port, want, tol=GRAD_TOL, what=""):
    assert len(port) == len(want)
    for i, (a, b) in enumerate(zip(port, want)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, err_msg=f"{what} leaf {i}", **tol)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_lm_loss_and_grads_match_jax(arch, mode):
    jcfg, tcfg = configs(arch, mode)
    w = np_weights(jcfg)
    batch = np_batch(tcfg)
    jl, jstats, jg = jax_loss_grads(jcfg, w, batch)
    tl, tstats, tg = port_loss_grads(tcfg, w, batch)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    assert tstats == jstats
    if mode == "off":
        assert tstats == [0, 0, 0]
    else:
        # 2 accepted ALF steps and 3 f-evals (v0 + one a step) a branch
        branches = sum(1 + (sp.mlp != "none") for sp in tcfg.layers())
        assert tstats == [2 * branches, 0, 3 * branches]
    assert_grads_close(tg, jg, what=f"{arch} {mode}")


def test_mali_matches_naive_gradients_on_lm_loss():
    """The port's MALI against its Naive on the full LM loss, as the JAX
    package's ``tests/test_train.py`` holds its own (qwen3 smoke, 2 ALF
    steps a branch, batch 2 x 8, rtol 2e-3 / atol 1e-5)."""
    def grads(method):
        cfg = smoke_config("qwen3-1.7b", OdeSettings(**MODES[method]))
        params = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
        leaves, spec = tree_util.tree_flatten(params)
        leaves = [leaf.requires_grad_() for leaf in leaves]
        batch = batch_to_device(make_batch(
            cfg, DataConfig(seed=0, global_batch=2, seq_len=8), 0), "cpu")
        loss = lm_loss(tree_util.tree_unflatten(leaves, spec), cfg, batch)
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads("mali"), grads("naive")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-5)


# configs with every layer kind the port trains: dense attention, the
# embeddings frontend, Mamba, MoE, a dense prelude
OP_ARCHS = ["qwen3-1.7b", "gemma2-2b", "stablelm-1.6b", "granite-20b",
            "musicgen-large", "internvl2-76b", "jamba-v0.1-52b",
            "deepseek-moe-16b"]


@pytest.mark.parametrize("arch", OP_ARCHS)
def test_training_step_calls_no_lm_op(arch):
    """A forward + backward of the loss with MALI on ``ALF(backend=
    "cuda")`` calls none of the three LM ops, and per residual branch
    exactly 2 alf_midpoint, 2 alf_update, 2 alf_bwd_pre and 2
    alf_bwd_post (2 ALF steps), no other ALF op."""
    ode = OdeSettings(**MODES["mali"], backend="cuda")
    cfg = smoke_config(arch, ode)
    params = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves, spec = tree_util.tree_flatten(params)
    leaves = [leaf.requires_grad_() for leaf in leaves]
    batch = batch_to_device(make_batch(cfg, DataConfig(global_batch=2,
                                                       seq_len=8), 0), "cpu")
    for ops in (alf_ops, fa_ops, rn_ops, scan_ops):
        ops.reset_op_calls()
    loss = lm_loss(tree_util.tree_unflatten(leaves, spec), cfg, batch)
    torch.autograd.grad(loss, leaves, allow_unused=True)
    branches = sum(1 + (spec.mlp != "none") for spec in cfg.layers())
    want = {name: 0 for name in alf_ops.OP_CALLS}
    for name in ("alf_midpoint", "alf_update", "alf_bwd_pre",
                 "alf_bwd_post"):
        want[name] = 2 * branches
    assert dict(alf_ops.OP_CALLS) == want
    for ops in (fa_ops, rn_ops, scan_ops):
        assert all(n == 0 for n in ops.OP_CALLS.values()), ops.OP_CALLS
