"""The port's stub frontend (``repro_torch.models.frontend``) and input
specs (``repro_torch.launch.specs``) on the CPU against the JAX package's.

The frontend's draws come from a ``torch.Generator`` where the JAX
package's come from a PRNG key, so the two are held to the same shapes,
dtypes, range and scale, not to the same values. The specs are meta
tensors where the JAX package's are ``jax.ShapeDtypeStruct`` leaves from
``jax.eval_shape``: for the ten configs at full width and every shape cell
that applies to them (``cell_applicable``), with the ODE off and under
``DEFAULT_ODE`` (3 cache slots per attention layer), the two trees have
the same key paths, and every leaf the same shape and dtype. Key paths
are compared sorted: torch flattens dicts in insertion order, JAX in
sorted key order.
"""
import dataclasses
import resource

import jax
import numpy as np
import pytest
import torch

from repro.configs import DEFAULT_ODE as JAX_DEFAULT_ODE
from repro.configs import SHAPE_CELLS as JAX_SHAPE_CELLS
from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jspecs
from repro.models import frontend as jfrontend
from repro_torch.configs import (ARCHS, DEFAULT_ODE, SHAPE_CELLS,
                                 cell_applicable, get_config, smoke_config)
from repro_torch.launch import specs as tspecs
from repro_torch.models import frontend as tfrontend
from repro_torch.models import init_lm, init_serve_state

FRONTEND_ARCHS = ["musicgen-large", "internvl2-76b"]
# a draw of B x S x d_model values: at 2 x 256 x 2048 the sample standard
# deviation lies within ~0.2% of the scale; 3% leaves room for the bf16
# rounding of each value
FRONTEND_BATCH, FRONTEND_SEQ = 2, 256
SCALE, SCALE_RTOL = 0.02, 0.03
ODES = {"off": (None, None), "default": (JAX_DEFAULT_ODE, DEFAULT_ODE)}
CELLS = [(arch, cell.name) for arch in sorted(ARCHS) for cell in SHAPE_CELLS
         if cell_applicable(get_config(arch), cell)[0]]
# grok-1-314b's bf16 weights
GROK_BYTES = 632_984_973_312


def _configs(arch, ode="off"):
    jode, tode = ODES[ode]
    return jax_get_config(arch, jode), get_config(arch, tode)


def _jax_cell(name):
    return next(c for c in JAX_SHAPE_CELLS if c.name == name)


def _port_cell(name):
    return next(c for c in SHAPE_CELLS if c.name == name)


def _key(entry) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unknown key path entry {entry!r}")


def _jax_leaves(tree):
    return sorted(
        (tuple(map(_key, path)), tuple(leaf.shape), str(leaf.dtype))
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])


def _port_leaves(tree):
    flat, _ = torch.utils._pytree.tree_flatten_with_path(tree)
    return sorted((tuple(map(_key, path)), tuple(leaf.shape),
                   str(leaf.dtype).split(".")[-1]) for path, leaf in flat)


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree_util.tree_leaves(tree))


def _all_meta(tree) -> bool:
    return all(t.is_meta for t in torch.utils._pytree.tree_leaves(tree))


# ---------------------------------------------------------------------------
# the stub frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frame_embeddings_match_the_jax_functions_shape_dtype_and_scale(
        arch):
    jcfg, tcfg = _configs(arch)
    want = jfrontend.synthetic_frame_embeddings(
        jax.random.PRNGKey(0), jcfg, FRONTEND_BATCH, FRONTEND_SEQ)
    got = tfrontend.synthetic_frame_embeddings(
        torch.Generator().manual_seed(0), tcfg, FRONTEND_BATCH,
        FRONTEND_SEQ, device="cpu")
    assert tuple(got.shape) == want.shape == (FRONTEND_BATCH, FRONTEND_SEQ,
                                              tcfg.d_model)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "bfloat16"
    for x in (got.float().numpy(), np.asarray(want, np.float32)):
        assert abs(float(x.std()) / SCALE - 1.0) < SCALE_RTOL
        assert abs(float(x.mean())) < 0.01 * SCALE
        # a normal draw: nothing past ~6 standard deviations at this size
        assert float(np.abs(x).max()) < 7 * SCALE
    again = tfrontend.synthetic_frame_embeddings(
        torch.Generator().manual_seed(0), tcfg, FRONTEND_BATCH,
        FRONTEND_SEQ, device="cpu")
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_labels_match_the_jax_functions_shape_dtype_and_range(arch):
    jcfg, tcfg = _configs(arch)
    want = np.asarray(jfrontend.synthetic_labels(
        jax.random.PRNGKey(0), jcfg, FRONTEND_BATCH, FRONTEND_SEQ))
    got = tfrontend.synthetic_labels(torch.Generator().manual_seed(0), tcfg,
                                     FRONTEND_BATCH, FRONTEND_SEQ,
                                     device="cpu")
    assert tuple(got.shape) == want.shape == (FRONTEND_BATCH, FRONTEND_SEQ)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    vocab = tcfg.vocab_size
    for x in (got.numpy(), want):
        assert x.min() >= 0 and x.max() < vocab
        # uniform over the vocabulary: the draw reaches both ends
        assert x.min() < 0.05 * vocab and x.max() > 0.95 * vocab
        assert abs(float(x.mean()) / (vocab - 1) - 0.5) < 0.05


def test_frontend_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = smoke_config("musicgen-large")
    for fn in (tfrontend.synthetic_frame_embeddings,
               tfrontend.synthetic_labels):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn(torch.Generator(), cfg, 1, 4)


def test_frame_embeddings_feed_the_embeds_path():
    """The drawn embeddings are a prefill input of an embeds config, and
    their specs are input_specs' batch."""
    from repro_torch.models import prefill
    cfg = smoke_config("musicgen-large", DEFAULT_ODE)
    gen = torch.Generator().manual_seed(1)
    embeds = tfrontend.synthetic_frame_embeddings(gen, cfg, 2, 8, "cpu")
    cell = dataclasses.replace(_port_cell("prefill_32k"), seq_len=8,
                               global_batch=2)
    spec = tspecs.input_specs(cfg, cell)["batch"]["embeds"]
    assert spec.shape == embeds.shape and spec.dtype == embeds.dtype
    params = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    logits, state = prefill(params, cfg, {"embeds": embeds},
                            init_serve_state(cfg, 2, 8, "cpu"))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and int(state.pos) == 8


# ---------------------------------------------------------------------------
# the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ode", list(ODES))
@pytest.mark.parametrize("arch,cell", CELLS,
                         ids=[f"{a}-{c}" for a, c in CELLS])
def test_input_specs_match_jax(arch, cell, ode):
    jcfg, tcfg = _configs(arch, ode)
    assert cell_applicable(tcfg, _port_cell(cell)) == \
        jax_cell_applicable(jcfg, _jax_cell(cell))
    want = jspecs.input_specs(jcfg, _jax_cell(cell))
    got = tspecs.input_specs(tcfg, _port_cell(cell))
    assert _all_meta(got)
    assert _port_leaves(got) == _jax_leaves(want)
    assert tspecs.tree_bytes(got) == _jax_bytes(want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    want = jspecs.param_specs(jcfg)
    got = tspecs.param_specs(tcfg)
    assert _all_meta(got)
    assert _port_leaves(got) == _jax_leaves(want)
    assert tspecs.tree_bytes(got) == _jax_bytes(want)


def test_grok_param_bytes_without_allocating():
    """grok-1-314b's 633 GB of bf16 weights, counted on the meta device:
    nothing is allocated (every leaf is a meta tensor, and the process's
    peak grows by less than 1 GiB: one period's expert leaf alone, 8 x
    6144 x 32768 in bf16, is 3 GiB)."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    specs = tspecs.param_specs(get_config("grok-1-314b"))
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    assert _all_meta(specs)
    assert tspecs.tree_bytes(specs) == GROK_BYTES
    assert _jax_bytes(jspecs.param_specs(jax_get_config("grok-1-314b"))) \
        == GROK_BYTES
    expert = specs["blocks"]["period"]["sub0"]["mlp"]["w_up"]
    assert expert[0].numel() * expert.element_size() == 3 * 2 ** 30
    assert grown < 2 ** 30


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_the_real_calls_at_smoke_size(arch):
    """The meta trees are the trees init_lm and init_serve_state make on
    the CPU, leaf for leaf, and tree_bytes their bytes."""
    cfg = smoke_config(arch, DEFAULT_ODE)
    cell = dataclasses.replace(_port_cell("decode_32k"), seq_len=24,
                               global_batch=2)
    real_params = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    real_state = init_serve_state(cfg, 2, 24, "cpu")
    params = tspecs.param_specs(cfg)
    state = tspecs.serve_state_specs(cfg, cell)
    assert _port_leaves(params) == _port_leaves(real_params)
    assert _port_leaves(state) == _port_leaves(real_state)
    assert tspecs.tree_bytes(params) == sum(
        t.numel() * t.element_size()
        for t in torch.utils._pytree.tree_leaves(real_params))
    assert tspecs.tree_bytes(state) == sum(
        t.numel() * t.element_size()
        for t in torch.utils._pytree.tree_leaves(real_state))


@pytest.mark.parametrize("arch,weights_gb,cache_gb", [
    ("deepseek-moe-16b", 32.8, 2.9), ("granite-20b", 56.3, 0.34),
    ("stablelm-1.6b", 3.3, 2.5), ("musicgen-large", 6.5, 5.0)])
def test_serve_memory_of_the_configs_served_on_the_card(arch, weights_gb,
                                                        cache_gb):
    """chip_smoke.py's configs_serve phase predicts each config's bf16
    weights and its cache (DEFAULT_ODE: 3 f-eval slots, batch 4 x 1056
    tokens) from these specs before it makes either."""
    cfg = get_config(arch, DEFAULT_ODE)
    cell = dataclasses.replace(_port_cell("decode_32k"), seq_len=1056,
                               global_batch=4)
    weights = tspecs.tree_bytes(tspecs.param_specs(cfg)) / 1e9
    cache = tspecs.tree_bytes(tspecs.serve_state_specs(cfg, cell)) / 1e9
    assert abs(weights - weights_gb) < 0.05
    assert abs(cache - cache_gb) < 0.05 * cache_gb
