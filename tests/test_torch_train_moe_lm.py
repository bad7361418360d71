"""The port's LM training loss and gradient on the CPU against the JAX
package, for the MoE smoke configs: deepseek-moe-16b (a dense prelude
layer, shared experts, top-k routing at the training capacity) with the
ODE off, MALI and Naive, and jamba-v0.1-52b (Mamba, attention and MoE)
with Naive; ``tests/test_torch_train_jamba.py`` holds Jamba's other two
modes (the JAX package takes ~30 s to compile each Jamba gradient).

Bars as ``tests/test_torch_train_lm.py``'s (loss 1e-5, gradients rtol
2e-4 / atol 2e-5 elementwise, counters equal), except where the smoke
Jamba's own amplification of rounding says the bar cannot be met: a
gradient leaf that misses it must lie within 3x the JAX package's own
noise floor for that leaf, max |jax(w') - jax(w)| / max |jax(w)| with
every weight w' moved by one float32 rounding (relative 1e-7), as the
serving tests hold whole-model Jamba results
(``tests/test_torch_ssm_serve.py``). Jamba runs one period of its
smoke config (8 layers: 7 Mamba, 1 attention, 4 MoE), every layer kind.
"""
import dataclasses

import jax
import numpy as np
import pytest

from test_torch_train_lm import (GRAD_TOL, LOSS_TOL, assert_grads_close,
                                 configs, jax_loss_grads, np_batch,
                                 np_weights, port_loss_grads)

EPS = 1e-7
FLOOR_FACTOR = 3.0


def perturbed(tree, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1.0 + EPS * rng.standard_normal(a.shape))
                   ).astype(np.float32), tree)


def check_case(arch, mode, **changes):
    jcfg, tcfg = configs(arch, mode, **changes)
    w = np_weights(jcfg)
    batch = np_batch(tcfg)
    jl, jstats, jg = jax_loss_grads(jcfg, w, batch)
    tl, tstats, tg = port_loss_grads(tcfg, w, batch)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    assert tstats == jstats
    if not changes:
        assert_grads_close(tg, jg, what=f"{arch} {mode}")
        return
    _, _, moved = jax_loss_grads(jcfg, perturbed(w), batch)
    for i, (a, b, m) in enumerate(zip(tg, jg, moved)):
        if np.allclose(a, b, **GRAD_TOL):
            continue
        scale = max(np.abs(b).max(), 1e-30)
        err = np.abs(a - b).max() / scale
        floor = np.abs(m - b).max() / scale
        assert err <= FLOOR_FACTOR * floor, (
            f"{arch} {mode} leaf {i}: relative max diff {err} > "
            f"{FLOOR_FACTOR} x the JAX package's noise floor {floor}")


@pytest.mark.parametrize("mode", ["off", "mali", "naive"])
def test_deepseek_loss_and_grads_match_jax(mode):
    check_case("deepseek-moe-16b", mode)


def test_jamba_naive_loss_and_grads_match_jax():
    check_case("jamba-v0.1-52b", "naive", n_periods=1)
