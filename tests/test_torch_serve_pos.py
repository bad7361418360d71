"""``ServeState.pos`` as a 0-d int32 device tensor, and the decode step
``serve()`` runs (``launch.serve.make_decode_step``), on the CPU against
the JAX package.

The same numpy weights (the JAX package's init, norm scales redrawn) and
numpy tokens feed both packages. On the CPU the port's kernel ops run
their plain versions and ``make_decode_step`` runs ``decode_step``
eagerly; the CUDA graph it captures on the card is held against eager
decode by ``chip_smoke.py``.

Tolerances, max |port - jax| / max |jax| over each compared array, as in
tests/test_torch_lm_serve.py: float32 1e-5 (summation orders; measured
~1e-6), bfloat16 3e-2 (bf16 roundings land differently in the two
frameworks). Positions are compared exactly; the port against itself
(``make_decode_step`` against ``decode_step``) bit for bit.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import DEFAULT_ODE as JAX_DEFAULT_ODE
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import init_serve_state as jax_init_serve_state
from repro_torch import params_from_numpy
from repro_torch.configs import DEFAULT_ODE, smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import (decode_step, init_lm, init_serve_state,
                                moe, prefill)

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 3e-2}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
B = 2


def _rel(port, want) -> float:
    p = np.asarray(port.float().numpy(), np.float64)
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    assert p.shape == w.shape, (p.shape, w.shape)
    return float(np.abs(p - w).max() / max(np.abs(w).max(), 1e-30))


def _configs(arch, dt):
    jcfg = jax_smoke_config(arch, JAX_DEFAULT_ODE)
    tcfg = smoke_config(arch, DEFAULT_ODE)
    if dt == "bf16":
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    return jcfg, tcfg


def _weights(jcfg, dt, seed=0):
    """The JAX package's init as f32 numpy, every norm scale redrawn
    around 1, handed to both packages in ``dt``."""
    rng = np.random.default_rng(seed + 100)
    params = jax_init_lm(jax.random.PRNGKey(seed),
                         dataclasses.replace(jcfg, param_dtype="float32"))

    def leaf(path, a):
        a = np.array(a, np.float32)
        if getattr(path[-1], "key", None) == "scale":
            a = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    w = jax.tree_util.tree_map_with_path(leaf, params)
    jw = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(JAX_DT[dt]),
                                w)
    return jw, params_from_numpy(w, device="cpu", dtype=TORCH_DT[dt])


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _run_both(arch, dt, prompt, n_decode):
    """Prefill ``prompt`` tokens, then ``n_decode`` teacher-forced decode
    steps in both packages; returns per call (jax logits, port logits,
    jax pos, port pos) and the final states."""
    jcfg, tcfg = _configs(arch, dt)
    jw, tw = _weights(jcfg, dt)
    toks = _tokens(tcfg, prompt + n_decode)
    s_max = prompt + n_decode
    jl, js = jax.jit(jax_make_prefill_step(jcfg))(
        jw, {"tokens": jnp.asarray(toks[:, :prompt])},
        jax_init_serve_state(jcfg, B, s_max))
    tl, ts = prefill(tw, tcfg, {"tokens": torch.tensor(toks[:, :prompt])},
                     init_serve_state(tcfg, B, s_max, "cpu"))
    out = [(jl, tl, js.pos, ts.pos)]
    jdec = jax.jit(jax_make_decode_step(jcfg))
    for i in range(n_decode):
        tok = toks[:, prompt + i:prompt + i + 1]
        jl, js = jdec(jw, jnp.asarray(tok), js)
        tl, ts = decode_step(tw, tcfg, torch.tensor(tok), ts)
        out.append((jl, tl, js.pos, ts.pos))
    return out, js, ts


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b"])
def test_pos_is_a_0d_int32_tensor_equal_to_the_jax_packages(arch):
    out, _, _ = _run_both(arch, "f32", 5, 3)
    for i, (_, _, jpos, tpos) in enumerate(out):
        assert isinstance(tpos, torch.Tensor) and tpos.dim() == 0
        assert tpos.dtype == torch.int32 and tpos.device.type == "cpu"
        assert int(tpos) == int(jpos) == 5 + i, (i, int(tpos), int(jpos))


def test_init_serve_state_pos_starts_at_zero():
    st = init_serve_state(smoke_config("qwen3-1.7b", DEFAULT_ODE), B, 4,
                          "cpu")
    assert st.pos.dim() == 0 and st.pos.dtype == torch.int32
    assert int(st.pos) == 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gemma2_decode_across_the_local_window_matches_jax(dt):
    """gemma2's smoke config alternates local (window 8) and global
    attention; a 6-token prompt and 6 decode steps take the query past
    the window's edge, so the tensor pos masks keys at both ends."""
    jcfg, tcfg = _configs("gemma2-2b", dt)
    assert tcfg.sliding_window == 8 == jcfg.sliding_window
    out, js, ts = _run_both("gemma2-2b", dt, 6, 6)
    for i, (jl, tl, jpos, tpos) in enumerate(out):
        err = _rel(tl, jl)
        assert err <= TOL[dt], f"logits {i}: {err} > {TOL[dt]}"
        assert int(tpos) == int(jpos)
    for j in sorted(ts.cache["period"]):
        for name in ("k", "v"):
            a = getattr(ts.cache["period"][j], name)
            b = getattr(js.cache["period"][j], name)
            err = _rel(a, b)
            assert err <= TOL[dt], f"{j}.{name}: {err} > {TOL[dt]}"


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b"])
def test_decode_logits_with_the_tensor_pos_match_jax(arch):
    out, _, _ = _run_both(arch, "f32", 7, 4)
    for i, (jl, tl, _, _) in enumerate(out):
        assert _rel(tl, jl) <= TOL["f32"], i


def test_attention_decode_writes_the_cache_at_the_tensor_pos():
    """K/V land at cache[slot, :, pos] (an index op on the device) and
    nowhere else."""
    cfg = smoke_config("qwen3-1.7b", DEFAULT_ODE)
    gen = torch.Generator().manual_seed(0)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    params = {"wq": torch.randn(d, h * dh, generator=gen),
              "wk": torch.randn(d, kv * dh, generator=gen),
              "wv": torch.randn(d, kv * dh, generator=gen),
              "wo": torch.randn(h * dh, d, generator=gen),
              "q_norm": {"scale": torch.ones(dh)},
              "k_norm": {"scale": torch.ones(dh)}}
    cache = tattn.KVCache.init(cfg, 3, B, 9, "cpu")
    x = torch.randn(B, 1, d, generator=gen)
    pos = torch.tensor(5, dtype=torch.int32)
    _, cache = tattn.attention_decode(params, cfg, cfg.period[0], x, pos,
                                      cache, 1)
    written = (cache.k != 0).any(-1).any(-1)          # [slot, B, S]
    assert written[1, :, 5].all()
    written[1, :, 5] = False
    assert not written.any()
    assert torch.equal((cache.v != 0).any(-1).any(-1)[1, :, 5],
                       torch.ones(B, dtype=torch.bool))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b", "jamba-v0.1-52b",
                                  "musicgen-large"])
def test_make_decode_step_on_the_cpu_equals_decode_step(arch):
    """On the CPU the serve step is decode_step itself: the same logits,
    cache and pos, bit for bit (musicgen feeds embeddings, jamba runs
    Mamba and MoE layers)."""
    cfg = smoke_config(arch, DEFAULT_ODE)
    params = init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    prompt = tserve.serve_prompt(cfg, B, 6, 0, "cpu")
    step = tserve.make_decode_step(cfg)
    runs = {}
    for name, fn in (("eager", lambda p, t, s: decode_step(p, cfg, t, s)),
                     ("serve", step)):
        _, st = prefill(params, cfg, prompt,
                        init_serve_state(cfg, B, 9, "cpu"))
        logits = []
        for i in range(3):
            if cfg.input_mode == "embeds":
                inp = torch.full((B, 1, cfg.d_model), 1e-3 * (i + 1))
            else:
                inp = torch.tensor(_tokens(cfg, 3)[:, i:i + 1])
            lg, st = fn(params, inp, st)
            logits.append(lg)
        runs[name] = (logits, st)
    for a, b in zip(pytree.tree_leaves(runs["serve"]),
                    pytree.tree_leaves(runs["eager"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(runs["serve"][1].pos) == 9


def test_make_decode_step_dispatches_by_the_state_device():
    """No fallback: a state on a device with neither a graph nor a plain
    path raises; on the meta device the step runs eagerly, the plain
    versions computing only shapes (what the dry run counts)."""
    import types
    cfg = smoke_config("qwen3-1.7b", DEFAULT_ODE)
    st = init_serve_state(cfg, B, 4, "cpu")
    other = st._replace(pos=types.SimpleNamespace(device=torch.device("xpu")))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tserve.make_decode_step(cfg)({}, torch.zeros(B, 1), other)
    from repro_torch.launch.specs import META, param_specs
    step = tserve.make_decode_step(cfg)
    logits, st2 = step(param_specs(cfg),
                       torch.zeros((B, 1), dtype=torch.int64, device=META),
                       init_serve_state(cfg, B, 4, META))
    assert not step.graphed
    assert logits.is_meta and logits.shape == (B, 1, cfg.vocab_size)
    assert st2.pos.is_meta


def test_decode_graph_refuses_to_capture_while_routes_are_recorded():
    """The routes of a captured step would be recorded once, at capture:
    the capture raises before it touches the device."""
    cfg = smoke_config("jamba-v0.1-52b", DEFAULT_ODE)
    st = init_serve_state(cfg, B, 4, "cpu")
    assert not moe.routes_recording()
    with moe.recording_routes():
        assert moe.routes_recording()
        with pytest.raises(RuntimeError, match="recording_routes"):
            tserve.DecodeGraph(cfg)({}, torch.zeros(B, 1, dtype=torch.long),
                                    st)
    assert not moe.routes_recording()


def test_a_dropped_decode_step_frees_its_graph_without_the_collector():
    """A CUDA graph that the cyclic collector frees inside another
    capture ends that capture with an error: a dropped step, and the
    DecodeGraph it holds, go when their last reference does."""
    cfg = smoke_config("qwen3-1.7b", DEFAULT_ODE)
    step = tserve.make_decode_step(cfg)
    graph = weakref.ref(step.graph)
    was_on = gc.isenabled()
    gc.disable()
    try:
        del step
        assert graph() is None
    finally:
        if was_on:
            gc.enable()


@pytest.mark.parametrize("on", [True, False])
def test_no_cyclic_gc_holds_the_collector_off_and_restores_it(on):
    """The decode graph's capture runs with the cyclic collector off, and
    leaves it as it found it, also when the block raises."""
    was_on = gc.isenabled()
    (gc.enable if on else gc.disable)()
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with tserve._no_cyclic_gc():
                assert not gc.isenabled()
                raise RuntimeError("inside")
        assert gc.isenabled() == on
    finally:
        (gc.enable if was_on else gc.disable)()
