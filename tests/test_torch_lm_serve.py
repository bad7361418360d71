"""The port's LM serving slice (``repro_torch.models``, ``configs``,
``core.ode_block``, ``launch.serve``) on the CPU against the JAX package.

The same weights feed both packages: the JAX package's ``init_lm`` makes
them, every norm scale is redrawn with numpy (so a dropped scale shows),
and the numpy tree goes to both (``params_from_numpy`` for the port, leaf
for leaf: the layouts are the same). Prompts and decode tokens come from a
numpy seed. On the CPU the port's kernel ops run their plain versions.

Tolerances, max |port - jax| / max |jax| over each compared array:
float32 1e-5 (the JAX package's and the port's f32 math in other
summation orders; measured ~1e-6), bfloat16 3e-2 (the bf16 roundings of
two layers x three f-evals land differently in the two frameworks;
measured ~1e-2, and tests/test_kernels.py holds the Pallas kernels to
3e-2 in bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import DEFAULT_ODE as JAX_DEFAULT_ODE
from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtf
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import init_serve_state as jax_init_serve_state
from repro_torch import params_from_numpy, params_to_numpy
from repro_torch.configs import (ARCHS, DEFAULT_ODE, OdeSettings,
                                 get_config, smoke_config)
from repro_torch.core import ALF, MALI, AdaptiveController, ConstantSteps
from repro_torch.core import Naive, SaveAt
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import decode_step, init_lm, init_serve_state
from repro_torch.models import mlp as tmlp
from repro_torch.models import prefill
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 3e-2}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# qwen3 (GQA, qk-norm), gemma2 (softcap, window, tied embeddings),
# stablelm (MHA), granite (MQA, one KV head), musicgen and internvl2
# (input_mode="embeds": the stub frontends feed embeddings, not tokens)
SERVE_ARCHS = ["qwen3-1.7b", "gemma2-2b", "stablelm-1.6b", "granite-20b",
               "musicgen-large", "internvl2-76b"]
B, PROMPT, N_DECODE = 2, 12, 4


def _rel(port, want) -> float:
    p = np.asarray(port.float().numpy() if torch.is_tensor(port) else port,
                   np.float64)
    w = np.asarray(np.asarray(want, np.float32), np.float64)
    assert p.shape == w.shape, (p.shape, w.shape)
    return float(np.abs(p - w).max() / max(np.abs(w).max(), 1e-30))


def _assert_close(port, want, dt, what=""):
    err = _rel(port, want)
    assert err <= TOL[dt], f"{what}: relative max diff {err} > {TOL[dt]}"


def _configs(arch, ode_on, dt):
    jcfg = jax_smoke_config(arch, JAX_DEFAULT_ODE if ode_on
                            else JaxOdeSettings(mode="off"))
    tcfg = smoke_config(arch, DEFAULT_ODE if ode_on
                        else OdeSettings(mode="off"))
    if dt == "bf16":
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    return jcfg, tcfg


def _np_weights(jcfg, seed=0):
    """The JAX package's init, as writable f32 numpy, with every norm
    scale redrawn around 1."""
    rng = np.random.default_rng(seed + 100)
    params = jax_init_lm(jax.random.PRNGKey(seed),
                         dataclasses.replace(jcfg, param_dtype="float32"))

    def leaf(path, a):
        a = np.array(a, np.float32)
        if getattr(path[-1], "key", None) == "scale":
            a = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def _both(np_tree, dt):
    jt = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(JAX_DT[dt]),
                                np_tree)
    return jt, params_from_numpy(np_tree, device="cpu", dtype=TORCH_DT[dt])


def _inputs(cfg, n, seed=1):
    """Seeded prompt positions: token ids [B, n], or embeddings
    [B, n, d_model] for an input_mode="embeds" config. Slicing the
    sequence axis gives a prefill's or a decode step's input."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _batch(cfg, x):
    """A prefill batch of ``_inputs``."""
    return {"embeds" if cfg.input_mode == "embeds" else "tokens": x}


def _cache_leaves(cache):
    """(name, array) of a serve cache, the same order in both packages."""
    out = []
    for j in sorted(cache["period"]):
        kv = cache["period"][j]
        out += [(f"{j}.k", kv.k), (f"{j}.v", kv.v)]
    return out


# ---------------------------------------------------------------------------
# configs and OdeSettings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_equal_the_jax_packages(arch):
    assert dataclasses.asdict(ARCHS[arch]) == dataclasses.asdict(
        JAX_ARCHS[arch])
    assert dataclasses.asdict(smoke_config(arch, DEFAULT_ODE)) == \
        dataclasses.asdict(jax_smoke_config(arch, JAX_DEFAULT_ODE))


def test_ode_settings_fields_and_defaults_equal_the_jax_packages():
    assert dataclasses.asdict(OdeSettings()) == dataclasses.asdict(
        JaxOdeSettings())
    assert dataclasses.asdict(DEFAULT_ODE) == dataclasses.asdict(
        JAX_DEFAULT_ODE)


@pytest.mark.parametrize("bad", [
    dict(mode="sometimes"), dict(method="magic"), dict(solver="rk9"),
    dict(method="mali", solver="rk4"), dict(n_steps=-1), dict(max_steps=0),
    dict(rtol=-1.0), dict(t0=float("inf")), dict(t0=1.0, t1=1.0),
    dict(eta=0.5), dict(obs_times=(0.5,)), dict(backend="tpu"),
    dict(method="naive", solver="rk4", backend="pallas"),
    dict(batch_axis="data", obs_times=(0.0, 1.0))])
def test_ode_settings_validate_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        JaxOdeSettings(**bad).validate()
    with pytest.raises(ValueError):
        OdeSettings(**bad).validate()


def test_ode_settings_as_objects():
    solver, ctrl, grad, saveat = OdeSettings(
        mode="per_block", n_steps=3, eta=0.9, backend="pallas").as_objects()
    assert solver == ALF(eta=0.9, backend="cuda")
    assert ctrl == ConstantSteps(3) and grad == MALI()
    assert isinstance(saveat, SaveAt)
    assert (saveat.ts, saveat.steps, saveat.dense) == (None, False, False)
    _, ctrl, grad, saveat = OdeSettings(
        n_steps=0, method="naive", rtol=1e-3, atol=1e-4, max_steps=9,
        obs_times=(0.0, 0.5, 1.0)).as_objects()
    assert ctrl == AdaptiveController(1e-3, 1e-4, 9)
    assert grad == Naive()
    assert saveat.ts.tolist() == [0.0, 0.5, 1.0]


def test_ode_settings_batch_axis_is_a_later_slice():
    """``batch_axis`` lowers as in the JAX package: ``as_objects()``
    works and ``batching()`` is ``Sharded(axis=batch_axis)``."""
    from repro.core import Sharded as JSharded
    from repro.core.ode_block import OdeSettings as JOdeSettings
    from repro_torch.core import Sharded
    OdeSettings(batch_axis="data").as_objects()
    assert OdeSettings(batch_axis="data").batching() == Sharded(axis="data")
    assert JOdeSettings(batch_axis="data").batching() == JSharded(
        axis="data")
    assert OdeSettings().batching() is None


@pytest.mark.parametrize("arch,kind", [("xlstm-125m", "mlstm")])
def test_unported_layer_kinds_raise(arch, kind):
    cfg = smoke_config(arch, DEFAULT_ODE)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match=f"'{kind}'.*ROADMAP"):
        init_lm(gen, cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_serve_state(cfg, 1, 8, "cpu")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta, dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x).astype(JAX_DT[dt]),
                              jnp.asarray(pos), theta)
    got = tcommon.apply_rope(torch.tensor(x).to(TORCH_DT[dt]),
                             torch.tensor(pos), theta)
    assert got.dtype == TORCH_DT[dt]
    _assert_close(got, want, dt, "apply_rope")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_mlp_matches_jax(dt):
    jcfg, _ = _configs("qwen3-1.7b", True, dt)
    w = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jax.random.PRNGKey(3),
                                  dataclasses.replace(
                                      jcfg, param_dtype="float32"), 128))
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(
        np.float32)
    jw, tw = _both(w, dt)
    want = jmlp.apply_mlp(jw, jnp.asarray(x).astype(JAX_DT[dt]))
    got = tmlp.apply_mlp(tw, torch.tensor(x).to(TORCH_DT[dt]))
    _assert_close(got, want, dt, "apply_mlp")


def _layer_setup(arch, ode_on, dt, seed=0):
    jcfg, tcfg = _configs(arch, ode_on, dt)
    w = _np_weights(jcfg, seed)
    layer = jax.tree_util.tree_map(lambda a: a[0],
                                   w["blocks"]["period"]["sub0"])
    jl, tl = _both(layer, dt)
    return jcfg, tcfg, jl, tl


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_attention_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jl, tl = _layer_setup(arch, True, "f32")
    spec = tcfg.period[0]
    s_max = PROMPT + 2
    x = np.random.default_rng(2).standard_normal(
        (B, PROMPT + 2, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32), (B, 1))
    jc = jattn.KVCache.init(jcfg, 3, B, s_max)
    tc = tattn.KVCache.init(tcfg, 3, B, s_max, "cpu")
    jy, jc = jattn.attention_prefill(jl["mixer"], jcfg, spec,
                                     jnp.asarray(x[:, :PROMPT]),
                                     jnp.asarray(pos), jc, 1)
    ty, tc2 = tattn.attention_prefill(tl["mixer"], tcfg, spec,
                                      torch.tensor(x[:, :PROMPT]),
                                      torch.tensor(pos), tc, 1)
    assert tc2 is tc                       # written in place
    _assert_close(ty, jy, "f32", "prefill output")
    for i in range(2):
        p = PROMPT + i
        jy, jc = jattn.attention_decode(jl["mixer"], jcfg, spec,
                                        jnp.asarray(x[:, p:p + 1]),
                                        jnp.int32(p), jc, 1)
        ty, tc = tattn.attention_decode(tl["mixer"], tcfg, spec,
                                        torch.tensor(x[:, p:p + 1]),
                                        torch.tensor(p, dtype=torch.int32),
                                        tc, 1)
        _assert_close(ty, jy, "f32", f"decode output {i}")
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        _assert_close(a, b, "f32", "cache")


@pytest.mark.parametrize("ode_on", [True, False], ids=["ode", "off"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_layer_serve_matches_jax(arch, ode_on):
    jcfg, tcfg, jl, tl = _layer_setup(arch, ode_on, "f32")
    spec = tcfg.period[0]
    slots = ttf.n_cache_slots(tcfg)
    assert slots == jtf.n_cache_slots(jcfg) == (3 if ode_on else 1)
    x = np.random.default_rng(4).standard_normal(
        (B, PROMPT, tcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(PROMPT, dtype=np.int32), (B, 1))
    jc = jattn.KVCache.init(jcfg, slots, B, PROMPT + 1)
    tc = tattn.KVCache.init(tcfg, slots, B, PROMPT + 1, "cpu")
    jy, jc = jtf.layer_serve(jl, jcfg, spec, jnp.asarray(x), jc,
                             jnp.asarray(pos), "prefill")
    ty, tc = ttf.layer_serve(tl, tcfg, spec, torch.tensor(x), tc,
                             torch.tensor(pos), "prefill")
    _assert_close(ty, jy, "f32", "layer_serve prefill")
    _assert_close(tc.k, jc.k, "f32", "layer_serve cache k")
    jy, jc = jtf.layer_serve(jl, jcfg, spec, jnp.asarray(x[:, :1]), jc,
                             jnp.int32(PROMPT), "decode")
    ty, tc = ttf.layer_serve(tl, tcfg, spec, torch.tensor(x[:, :1]), tc,
                             torch.tensor(PROMPT, dtype=torch.int32),
                             "decode")
    _assert_close(ty, jy, "f32", "layer_serve decode")
    _assert_close(tc.v, jc.v, "f32", "layer_serve cache v")


# ---------------------------------------------------------------------------
# the whole slice: prefill + decode
# ---------------------------------------------------------------------------

def _run_both(arch, ode_on, dt, n_decode=N_DECODE):
    jcfg, tcfg = _configs(arch, ode_on, dt)
    jw, tw = _both(_np_weights(jcfg), dt)
    toks = _inputs(tcfg, PROMPT + n_decode)
    s_max = PROMPT + n_decode
    jpre = jax.jit(jax_make_prefill_step(jcfg))
    jdec = jax.jit(jax_make_decode_step(jcfg))
    jl, js = jpre(jw, _batch(jcfg, jnp.asarray(toks[:, :PROMPT])),
                  jax_init_serve_state(jcfg, B, s_max))
    tl, ts = prefill(tw, tcfg, _batch(tcfg, torch.tensor(toks[:, :PROMPT])),
                     init_serve_state(tcfg, B, s_max, "cpu"))
    out = [(jl, tl)]
    for i in range(n_decode):
        tok = toks[:, PROMPT + i:PROMPT + i + 1]
        jl, js = jdec(jw, jnp.asarray(tok), js)
        tl, ts = decode_step(tw, tcfg, torch.tensor(tok), ts)
        out.append((jl, tl))
    return out, js, ts


@pytest.mark.parametrize("ode_on", [True, False], ids=["ode", "off"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_jax_f32(arch, ode_on):
    logits, js, ts = _run_both(arch, ode_on, "f32")
    for i, (jl, tl) in enumerate(logits):
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, 256)
        _assert_close(tl, jl, "f32", f"logits {i}")
    assert ts.pos == int(js.pos) == PROMPT + N_DECODE
    for (name, a), (_, b) in zip(_cache_leaves(ts.cache),
                                 _cache_leaves(js.cache)):
        _assert_close(a, b, "f32", name)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_jax_bf16(arch):
    logits, js, ts = _run_both(arch, True, "bf16")
    for i, (jl, tl) in enumerate(logits):
        _assert_close(tl, jl, "bf16", f"logits {i}")
    for (name, a), (_, b) in zip(_cache_leaves(ts.cache),
                                 _cache_leaves(js.cache)):
        assert a.dtype == torch.bfloat16
        _assert_close(a, b, "bf16", name)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_then_decode_equals_longer_prefill(arch):
    """The last logits of a prefill over p+1 tokens equal prefill(p) then
    decode(token p) — the port's counterpart of tests/test_models.py's
    KV-cache check, here through the virtual-layer cache of the ODE
    blocks."""
    _, tcfg = _configs(arch, True, "f32")
    _, tw = _both(_np_weights(dataclasses.replace(
        jax_smoke_config(arch, JAX_DEFAULT_ODE))), "f32")
    toks = torch.tensor(_inputs(tcfg, PROMPT + 1))
    _, st = prefill(tw, tcfg, _batch(tcfg, toks[:, :PROMPT]),
                    init_serve_state(tcfg, B, PROMPT + 1, "cpu"))
    a, _ = decode_step(tw, tcfg, toks[:, PROMPT:], st)
    b, _ = prefill(tw, tcfg, _batch(tcfg, toks),
                   init_serve_state(tcfg, B, PROMPT + 1, "cpu"))
    assert _rel(a, b.numpy()) <= 1e-5


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_reference_backend_equals_kernel_backend_on_cpu(arch):
    """On the CPU both backends run the plain versions: bit-equal."""
    _, tcfg = _configs(arch, True, "f32")
    _, tw = _both(_np_weights(jax_smoke_config(arch, JAX_DEFAULT_ODE)),
                  "f32")
    toks = torch.tensor(_inputs(tcfg, PROMPT))
    out = {}
    for backend in ("cuda", "reference"):
        lg, st = prefill(tw, tcfg, _batch(tcfg, toks),
                         init_serve_state(tcfg, B, PROMPT + 1, "cpu"),
                         backend=backend)
        lg2, _ = decode_step(tw, tcfg, toks[:, :1], st, backend=backend)
        out[backend] = (lg, lg2, st.cache)
    for a, b in zip(pytree.tree_leaves(out["cuda"]),
                    pytree.tree_leaves(out["reference"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# op calls: the launch counts the card sees, counted on the CPU
# ---------------------------------------------------------------------------

def _reset():
    alf_ops.reset_op_calls()
    fa_ops.reset_op_calls()
    rn_ops.reset_op_calls()


def _calls():
    return {"flash_attention": fa_ops.OP_CALLS["flash_attention"],
            "rmsnorm": rn_ops.OP_CALLS["rmsnorm"],
            "alf_midpoint": alf_ops.OP_CALLS["alf_midpoint"],
            "alf_update": alf_ops.OP_CALLS["alf_update"]}


def expected_calls(cfg, kind):
    """Op calls of one prefill or decode step of an attention/dense LM:
    per layer, (n_steps + 1) f-evals per branch (1 with the ODE off), each
    mixer eval one norm (+ q- and k-norm) and, in prefill, one flash
    attention; each mlp eval one norm; one ALF midpoint and update per
    step and branch; plus the final norm."""
    n = cfg.n_layers
    evals = 1 if cfg.ode.mode == "off" else cfg.ode.n_steps + 1
    steps = 0 if cfg.ode.mode == "off" else cfg.ode.n_steps
    mixer_norms = 3 if cfg.qk_norm else 1
    return {"flash_attention": n * evals if kind == "prefill" else 0,
            "rmsnorm": n * evals * (mixer_norms + 1) + 1,
            "alf_midpoint": n * 2 * steps, "alf_update": n * 2 * steps}


def test_expected_calls_of_qwen3_at_full_depth():
    """The counts chip_smoke.py asserts for qwen3-1.7b on the card."""
    cfg = get_config("qwen3-1.7b", DEFAULT_ODE)
    assert expected_calls(cfg, "prefill") == {
        "flash_attention": 84, "rmsnorm": 337, "alf_midpoint": 112,
        "alf_update": 112}
    assert expected_calls(cfg, "decode") == {
        "flash_attention": 0, "rmsnorm": 337, "alf_midpoint": 112,
        "alf_update": 112}


@pytest.mark.parametrize("ode_on", [True, False], ids=["ode", "off"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_op_calls_per_prefill_and_decode_step(arch, ode_on):
    _, tcfg = _configs(arch, ode_on, "f32")
    tw = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    toks = torch.tensor(_inputs(tcfg, PROMPT + 1))
    state = init_serve_state(tcfg, B, PROMPT + 1, "cpu")
    _reset()
    _, state = prefill(tw, tcfg, _batch(tcfg, toks[:, :PROMPT]), state)
    assert _calls() == expected_calls(tcfg, "prefill")
    _reset()
    decode_step(tw, tcfg, toks[:, PROMPT:], state)
    assert _calls() == expected_calls(tcfg, "decode")
    _reset()
    decode_step(tw, tcfg, toks[:, PROMPT:], state, backend="reference")
    assert set(_calls().values()) == {0}


# ---------------------------------------------------------------------------
# init and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_init_lm_has_the_jax_packages_layout(arch):
    jcfg, tcfg = _configs(arch, True, "f32")
    want = jax.eval_shape(lambda: jax_init_lm(jax.random.PRNGKey(0), jcfg))
    got = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(want)[0]
    tl = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(params_to_numpy(got))[0]}
    assert len(jl) == len(tl)
    for path, leaf in jl:
        assert tl[jax.tree_util.keystr(path)].shape == leaf.shape


def test_init_lm_is_seeded_and_scaled():
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), d_model=256,
                              d_ff=512)
    a = init_lm(torch.Generator().manual_seed(3), cfg, "cpu")
    b = init_lm(torch.Generator().manual_seed(3), cfg, "cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))
    wq = a["blocks"]["period"]["sub0"]["mixer"]["wq"]
    assert tuple(wq.shape) == (cfg.n_periods, 256, cfg.n_heads * 16)
    assert float(wq.abs().max()) <= 2.0 * 256 ** -0.5 + 1e-6
    assert abs(float(wq.std()) - 0.88 * 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(float(a["embed"].std()) - 0.02) < 0.002


def test_serve_runs_on_the_cpu_when_asked(capsys):
    res = tserve.serve("qwen3-1.7b", prompt_len=8, decode_tokens=3,
                       batch=2, device="cpu")
    assert res.tokens.shape == (2, 3)
    assert res.tokens.min() >= 0 and res.tokens.max() < 256
    assert res.prefill_ms > 0 and res.decode_tok_s > 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out


def test_serve_embeds_frontend_on_the_cpu(capsys):
    """musicgen's stub frontend: the prompt is embeddings and each decode
    step feeds the last token id through the fixed projection."""
    res = tserve.serve("musicgen-large", prompt_len=6, decode_tokens=3,
                       batch=2, device="cpu")
    assert res.tokens.shape == (2, 3)
    assert res.tokens.min() >= 0 and res.tokens.max() < 256
    assert "arch=musicgen-large-smoke" in capsys.readouterr().out


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tserve.serve("qwen3-1.7b", prompt_len=4, decode_tokens=1)


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_main_mode_ode_runs_on_the_cpu(engine):
    """``python -m repro_torch.launch.serve --mode ode --device cpu`` as
    users call it, with tests/test_serve.py's TestServeCLI arguments."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "ode",
         "--ode-engine", engine, "--batch", "2", "--requests", "5",
         "--d-state", "4", "--chunk-steps", "8", "--rate", "500", "--seed",
         "3", "--t1", "0.5", "--rtol", "1e-3", "--atol", "1e-4",
         "--max-steps", "128", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=root, timeout=120,
        check=True).stdout
    assert "batch(slots)=2" in out
    assert "t1=0.5" in out and "seed=3" in out
    assert f"engine={engine}" in out and f"serve[{engine}]" in out
    assert "5 completed" in out


def test_serve_ode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tserve.serve_ode(batch=2, d_state=4, n_requests=2)


def test_main_lm_flags(capsys):
    tserve.main(["--arch", "gemma2-2b", "--prompt-len", "6",
                 "--decode-tokens", "2", "--batch", "1", "--ode", "off",
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=gemma2-2b-smoke batch=1 prompt=6 decode=2" in out
