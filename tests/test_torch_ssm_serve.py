"""The port's Jamba/SSM + MoE serving slice (``models/ssm.py``,
``models/moe.py``, the Mamba, MoE and prelude branches of
``models/transformer.py``) on the CPU against the JAX package.

The same weights feed both packages: the JAX package's ``init_lm`` makes
them (every norm scale redrawn with numpy, so a dropped scale shows), each
leaf keeps the dtype the JAX init gives it (the router, ``A_log``, ``D``
and ``dt_bias`` stay float32 in a bfloat16 model), and the numpy tree goes
to both (``params_from_numpy`` for the port, leaf for leaf). Prompts and
decode tokens come from a numpy seed. On the CPU the port's kernel ops run
their plain versions.

Tolerances, max |port - jax| / max |jax| over each compared array, as in
tests/test_torch_lm_serve.py: float32 1e-5, bfloat16 3e-2. Module level,
the Mamba prefill is held elementwise to rtol 1e-4 / atol 1e-5, the JAX
package's own chunked-prefill bar: the JAX package sums the recurrence by
an associative scan, the port sequentially.

Whole models: these smoke models amplify rounding differences, the Jamba
one most (its first layer alone turns a 1e-7 relative change of its input
into 2.8e-6 of its output under the ODE; every layer agrees with the JAX
package's to ~1e-7 given the same input, yet the logits of the 16 layers
differ by up to 6.9e-5 in f32), and a bf16 route that flips at a near-tie
of the router moves a token's logits by O(1). So each whole-model
comparison is held to the larger of the tolerance above and 3x the JAX
package's own noise floor: how far its result moves when every weight is
perturbed by one rounding of the dtype (relative 1e-7 in f32, 2^-8 in
bf16). The port's distance to the JAX package stays within 1.5x that
floor; the floor binds only for Jamba (both dtypes: in bf16 the JAX
package's own result moves by O(1), so the whole-model bf16 check of
Jamba says little — the Mamba and MoE module tests above hold its bf16
arithmetic) and for a few bf16 decode steps of the MoE models.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import DEFAULT_ODE as JAX_DEFAULT_ODE
from repro.configs import smoke_config as jax_smoke_config
from repro.core.ode_block import OdeSettings as JaxOdeSettings
from repro.launch.steps import make_decode_step as jax_make_decode_step
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import init_serve_state as jax_init_serve_state
from repro_torch import params_from_numpy, params_to_numpy
from repro_torch.configs import (DEFAULT_ODE, OdeSettings, get_config,
                                 smoke_config)
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import decode_step, init_lm, init_serve_state
from repro_torch.models import moe as tmoe
from repro_torch.models import prefill
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.common import materialize

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 3e-2}
# one rounding of the dtype, relative: the perturbation of the noise floor
EPS = {"f32": 1e-7, "bf16": 2.0 ** -8}
FLOOR_FACTOR = 3.0
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# jamba (Mamba + attention, MoE at odd indices), deepseek-moe-16b (a dense
# prelude layer, shared experts), grok-1 (MoE in every layer)
ARCHS = ["jamba-v0.1-52b", "deepseek-moe-16b", "grok-1-314b"]
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


def _assert_within_floor(port, want, moved, dt, what=""):
    """|port - want| within max(TOL, FLOOR_FACTOR x |moved - want|), all
    relative to max |want|; ``moved`` is the reference's result with
    perturbed weights."""
    err, floor = _rel(port, want), _rel(moved, want)
    tol = max(TOL[dt], FLOOR_FACTOR * floor)
    assert err <= tol, (f"{what}: relative max diff {err} > {tol} (the "
                        f"reference's noise floor {floor})")


def _perturbed(np_tree, dt, seed=7):
    """Every weight times (1 + EPS[dt] * normal)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1.0 + EPS[dt] * rng.standard_normal(a.shape))
                   ).astype(np.float32), np_tree)


def _configs(arch, ode_on=True, dt="f32", **changes):
    jcfg = jax_smoke_config(arch, JAX_DEFAULT_ODE if ode_on
                            else JaxOdeSettings(mode="off"))
    tcfg = smoke_config(arch, DEFAULT_ODE if ode_on
                        else OdeSettings(mode="off"))
    if dt == "bf16":
        changes.update(param_dtype="bfloat16", compute_dtype="bfloat16")
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(tcfg, **changes))


@functools.lru_cache(maxsize=None)
def _np_weights(jcfg, seed=0):
    """The JAX package's init in jcfg's dtypes, as writable f32 numpy with
    every norm scale redrawn around 1, and the dtype of each leaf."""
    rng = np.random.default_rng(seed + 100)
    params = jax_init_lm(jax.random.PRNGKey(seed), jcfg)

    def leaf(path, a):
        a = np.array(a.astype(jnp.float32))
        if getattr(path[-1], "key", None) == "scale":
            a = (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map(lambda a: a.dtype, params))


def _both(np_tree, dtypes):
    """The numpy tree as JAX arrays and port tensors (CPU), each leaf in
    its JAX init dtype."""
    jt = jax.tree_util.tree_map(lambda a, d: jnp.asarray(a).astype(d),
                                np_tree, dtypes)
    tdt = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}
    tt = jax.tree_util.tree_map(
        lambda a, d: params_from_numpy(a, device="cpu", dtype=tdt[d]),
        np_tree, dtypes)
    return jt, tt


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _pair(a, dt):
    return jnp.asarray(a).astype(JAX_DT[dt]), torch.tensor(a).to(TORCH_DT[dt])


def _layer(arch, j, dt="f32", **changes):
    """Configs and sub-layer ``j`` of period 0 in both packages."""
    jcfg, tcfg = _configs(arch, True, dt, **changes)
    w, dts = _np_weights(jcfg)
    pick = functools.partial(jax.tree_util.tree_map, lambda a: a[0])
    jl, tl = _both(pick(w["blocks"]["period"][f"sub{j}"]),
                   dts["blocks"]["period"][f"sub{j}"])
    return jcfg, tcfg, jl, tl


# ---------------------------------------------------------------------------
# modules: Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("s", [4, 13])
def test_mamba_prefill_with_state_matches_jax(s, dt):
    jcfg, tcfg, jl, tl = _layer("jamba-v0.1-52b", 0, dt)
    jx, tx = _pair(_x((B, s, tcfg.d_model), 2), dt)
    jy, (jconv, jh) = jssm.apply_mamba_train(jl["mixer"], jcfg, jx,
                                             return_state=True)
    ty, (tconv, th) = tssm.apply_mamba_prefill(tl["mixer"], tcfg, tx,
                                               return_state=True)
    assert ty.dtype == TORCH_DT[dt]
    assert tconv.dtype == th.dtype == torch.float32
    for got, want, what in ((ty, jy, "output"), (tconv, jconv, "conv state"),
                            (th, jh, "h_last")):
        if dt == "f32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5, err_msg=what)
        else:
            _assert_close(got, want, dt, what)


def test_mamba_prefill_without_state_matches_jax():
    jcfg, tcfg, jl, tl = _layer("jamba-v0.1-52b", 2)
    jx, tx = _pair(_x((B, 9, tcfg.d_model), 3), "f32")
    got = tssm.apply_mamba_prefill(tl["mixer"], tcfg, tx)
    want = jssm.apply_mamba_train(jl["mixer"], jcfg, jx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_mamba_prefill_keeps_the_chunk_contract():
    """With state, S must be a multiple of the JAX package's chunk (4096)
    once it exceeds it (its ValueError), and at least d_conv - 1 for the
    conv state."""
    jcfg, tcfg, jl, tl = _layer("jamba-v0.1-52b", 0)
    x = _x((1, 4097, tcfg.d_model), 4)
    with pytest.raises(ValueError, match="seq_len % chunk"):
        jssm.apply_mamba_train(jl["mixer"], jcfg, jnp.asarray(x),
                               return_state=True)
    with pytest.raises(ValueError, match="seq_len % chunk"):
        tssm.apply_mamba_prefill(tl["mixer"], tcfg, torch.tensor(x),
                                 return_state=True)
    with pytest.raises(ValueError, match="d_conv - 1"):
        tssm.apply_mamba_prefill(tl["mixer"], tcfg, torch.tensor(x[:, :2]),
                                 return_state=True)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba_decode_matches_jax_at_a_slot_other_than_0(dt):
    jcfg, tcfg, jl, tl = _layer("jamba-v0.1-52b", 0, dt)
    di, _, st, k = tssm._dims(tcfg)
    conv, ssm = _x((3, B, k - 1, di), 5), _x((3, B, di, st), 6, 0.3)
    jc = jssm.MambaCache(jnp.asarray(conv), jnp.asarray(ssm))
    tc = tssm.MambaCache(torch.tensor(conv), torch.tensor(ssm))
    for i in range(2):
        jx, tx = _pair(_x((B, 1, tcfg.d_model), 7 + i), dt)
        jy, jc = jssm.apply_mamba_decode(jl["mixer"], jcfg, jx, jc, 2)
        ty, tc2 = tssm.apply_mamba_decode(tl["mixer"], tcfg, tx, tc, 2)
        assert tc2 is tc                              # written in place
        _assert_close(ty, jy, dt, f"decode output {i}")
    _assert_close(tc.conv, jc.conv, dt, "conv cache")
    _assert_close(tc.ssm, jc.ssm, dt, "ssm cache")
    assert torch.equal(tc.conv[:2], torch.tensor(conv[:2]))   # other slots
    assert torch.equal(tc.ssm[:2], torch.tensor(ssm[:2]))


def test_mamba_cache_layout_matches_jax():
    jcfg, tcfg = _configs("jamba-v0.1-52b")
    want = jssm.MambaCache.init(jcfg, 3, B)
    got = tssm.MambaCache.init(tcfg, 3, B, "cpu")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert not g.any()


# ---------------------------------------------------------------------------
# modules: MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("factor", [2.0, 0.5], ids=["dropless", "drops"])
@pytest.mark.parametrize("arch,j", [("deepseek-moe-16b", 0),
                                    ("grok-1-314b", 0),
                                    ("jamba-v0.1-52b", 1)])
def test_apply_moe_matches_jax(arch, j, factor, dt):
    """eval_mode=True, with shared experts (deepseek), and with capacity
    factor 0.5, where routes really are dropped."""
    jcfg, tcfg, jl, tl = _layer(arch, j, dt, moe_eval_capacity_factor=factor)
    jx, tx = _pair(_x((B, 10, tcfg.d_model), 8), dt)
    want = jmoe.apply_moe(jl["mlp"], jcfg, jx, eval_mode=True)
    with tmoe.recording_routes() as routes:
        got = tmoe.apply_moe(tl["mlp"], tcfg, tx, eval_mode=True)
    assert got.dtype == TORCH_DT[dt] and len(routes) == 1
    _assert_close(got, want, dt, "apply_moe")
    idx, kept = routes[0]
    n, k = B * 10, tcfg.moe_top_k
    assert tuple(idx.shape) == tuple(kept.shape) == (n, k)
    cap = tmoe._capacity(n, tcfg, factor)
    assert cap == jmoe._capacity(n, jcfg, factor)
    # no expert takes more than its capacity; every route past it drops
    per_expert = torch.bincount(idx[kept], minlength=tcfg.moe_experts)
    assert int(per_expert.max()) <= cap
    if factor < 1.0:
        assert not bool(kept.all())
        assert int(kept.sum()) == int(torch.clamp_max(
            torch.bincount(idx.reshape(-1), minlength=tcfg.moe_experts),
            cap).sum())
    else:
        assert bool(kept.all())


@pytest.mark.parametrize("n,factor,want", [
    (4, 2.0, 2),          # a Jamba decode step at batch 4: 2 per expert
    (4096, 2.0, 1024),    # Jamba's prefill, 4 x 1024 tokens
    (1, 2.0, 2),          # at least top_k
    (100, 0.5, 7)])
def test_capacity_matches_jax(n, factor, want):
    cfg = get_config("jamba-v0.1-52b")
    jcfg = dataclasses.replace(jax_smoke_config("jamba-v0.1-52b"),
                               moe_experts=16, moe_top_k=2)
    assert tmoe._capacity(n, cfg, factor) == want
    assert jmoe._capacity(n, jcfg, factor) == want


def test_recording_routes_nests_and_stops():
    _, tcfg, _, tl = _layer("grok-1-314b", 0)
    x = torch.tensor(_x((1, 3, tcfg.d_model), 9))
    with tmoe.recording_routes() as outer:
        tmoe.apply_moe(tl["mlp"], tcfg, x, eval_mode=True)
        with tmoe.recording_routes() as inner:
            tmoe.apply_moe(tl["mlp"], tcfg, x, eval_mode=True)
    tmoe.apply_moe(tl["mlp"], tcfg, x, eval_mode=True)
    assert (len(outer), len(inner)) == (2, 1)
    assert not tmoe._ROUTE_LOGS


# ---------------------------------------------------------------------------
# the whole slice: prefill + decode
# ---------------------------------------------------------------------------

def _inputs(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _jax_serve(jcfg, jw, toks):
    """The JAX package's prefill + teacher-forced decode steps: (logits
    per step, final state)."""
    s_max = PROMPT + N_DECODE
    jpre = jax.jit(jax_make_prefill_step(jcfg))
    jdec = jax.jit(jax_make_decode_step(jcfg))
    jl, js = jpre(jw, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                  jax_init_serve_state(jcfg, B, s_max))
    logits = [np.asarray(jl)]
    for i in range(N_DECODE):
        jl, js = jdec(jw, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]),
                      js)
        logits.append(np.asarray(jl))
    return logits, js


@functools.lru_cache(maxsize=None)
def _run_both(arch, ode_on, dt):
    """prefill + N_DECODE teacher-forced decode steps in both packages,
    and in the JAX package once more with perturbed weights: (JAX logits
    per step, port logits per step, perturbed JAX logits per step, JAX
    state, port state, perturbed JAX state, port op calls per prefill and
    per decode step)."""
    jcfg, tcfg = _configs(arch, ode_on, dt)
    w, dts = _np_weights(jcfg)
    jw, tw = _both(w, dts)
    toks = _inputs(tcfg, PROMPT + N_DECODE)
    jlog, js = _jax_serve(jcfg, jw, toks)
    plog, ps = _jax_serve(jcfg, _both(_perturbed(w, dt), dts)[0], toks)
    _reset()
    tl, ts = prefill(tw, tcfg, {"tokens": torch.tensor(toks[:, :PROMPT])},
                     init_serve_state(tcfg, B, PROMPT + N_DECODE, "cpu"))
    calls, tlog = [_calls()], [tl]
    for i in range(N_DECODE):
        _reset()
        tl, ts = decode_step(tw, tcfg, torch.tensor(
            toks[:, PROMPT + i:PROMPT + i + 1]), ts)
        calls.append(_calls())
        tlog.append(tl)
    return jlog, tlog, plog, js, ts, ps, calls


def _cache_leaves(cache):
    """(name, array) of a serve cache, the same order in both packages
    (KV caches: k, v; Mamba caches: conv, ssm)."""
    out = []
    for i, c in enumerate(cache.get("prelude", [])):
        out += [(f"prelude{i}.{n}", a) for n, a in zip(c._fields, c)]
    for j in sorted(cache["period"]):
        c = cache["period"][j]
        out += [(f"{j}.{n}", a) for n, a in zip(c._fields, c)]
    return out


CASES = [(a, o, d) for a in ARCHS for o in (True, False)
         for d in ("f32", "bf16")]


@pytest.mark.parametrize("arch,ode_on,dt", CASES,
                         ids=[f"{a}-{'ode' if o else 'off'}-{d}"
                              for a, o, d in CASES])
def test_prefill_and_decode_match_jax(arch, ode_on, dt):
    jlog, tlog, plog, js, ts, _, _ = _run_both(arch, ode_on, dt)
    for i, (jl, tl, pl) in enumerate(zip(jlog, tlog, plog)):
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, 256)
        _assert_within_floor(tl, jl, pl, dt, f"logits {i}")
    assert ts.pos == int(js.pos) == PROMPT + N_DECODE


@pytest.mark.parametrize("arch,ode_on,dt", CASES,
                         ids=[f"{a}-{'ode' if o else 'off'}-{d}"
                              for a, o, d in CASES])
def test_caches_match_jax(arch, ode_on, dt):
    _, _, _, js, ts, ps, _ = _run_both(arch, ode_on, dt)
    got, want = _cache_leaves(ts.cache), _cache_leaves(js.cache)
    moved = _cache_leaves(ps.cache)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b), (_, m) in zip(got, want, moved):
        assert tuple(a.shape) == b.shape, name
        assert a.dtype == {jnp.dtype(jnp.float32): torch.float32,
                           jnp.dtype(jnp.bfloat16): torch.bfloat16}[b.dtype]
        _assert_within_floor(a, b, m, dt, name)


# ---------------------------------------------------------------------------
# op calls: the launch counts the card sees, counted on the CPU
# ---------------------------------------------------------------------------

def _reset():
    for ops in (alf_ops, fa_ops, rn_ops, scan_ops):
        ops.reset_op_calls()


def _calls():
    return {"selective_scan": scan_ops.OP_CALLS["selective_scan"],
            "flash_attention": fa_ops.OP_CALLS["flash_attention"],
            "rmsnorm": rn_ops.OP_CALLS["rmsnorm"],
            "alf_midpoint": alf_ops.OP_CALLS["alf_midpoint"],
            "alf_update": alf_ops.OP_CALLS["alf_update"]}


def expected_calls(cfg, kind):
    """Op calls of one prefill or decode step: per layer (n_steps + 1)
    f-evals per residual branch (1 with the ODE off); each mixer eval one
    norm (+ q- and k-norm) and, in prefill, one flash attention (attention
    mixers) or one selective scan (Mamba mixers); each MLP eval one norm;
    one ALF midpoint and update per step and branch; plus the final
    norm."""
    layers = cfg.layers()
    evals = 1 if cfg.ode.mode == "off" else cfg.ode.n_steps + 1
    steps = 0 if cfg.ode.mode == "off" else cfg.ode.n_steps
    n_attn = sum(spec.mixer == "attn" for spec in layers)
    n_mamba = sum(spec.mixer == "mamba" for spec in layers)
    n_mlp = sum(spec.mlp != "none" for spec in layers)
    q_k = 2 if cfg.qk_norm else 0
    branches = len(layers) + n_mlp
    return {"selective_scan": n_mamba * evals if kind == "prefill" else 0,
            "flash_attention": n_attn * evals if kind == "prefill" else 0,
            "rmsnorm": evals * (len(layers) + n_attn * q_k + n_mlp) + 1,
            "alf_midpoint": branches * steps, "alf_update": branches * steps}


def test_expected_calls_of_jamba_at_two_of_four_periods():
    """The counts chip_smoke.py asserts for jamba-v0.1-52b on the card
    (2 of its 4 periods: 16 layers, 14 Mamba and 2 attention)."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", DEFAULT_ODE),
                              n_periods=2)
    assert expected_calls(cfg, "prefill") == {
        "selective_scan": 42, "flash_attention": 6, "rmsnorm": 97,
        "alf_midpoint": 64, "alf_update": 64}
    assert expected_calls(cfg, "decode") == {
        "selective_scan": 0, "flash_attention": 0, "rmsnorm": 97,
        "alf_midpoint": 64, "alf_update": 64}
    full = get_config("jamba-v0.1-52b", DEFAULT_ODE)
    assert expected_calls(full, "prefill")["selective_scan"] == 84


@pytest.mark.parametrize("arch,ode_on", [(a, o) for a in ARCHS
                                         for o in (True, False)],
                         ids=[f"{a}-{'ode' if o else 'off'}" for a in ARCHS
                              for o in (True, False)])
def test_op_calls_per_prefill_and_decode_step(arch, ode_on):
    calls = _run_both(arch, ode_on, "f32")[-1]
    _, tcfg = _configs(arch, ode_on)
    assert calls[0] == expected_calls(tcfg, "prefill")
    for c in calls[1:]:
        assert c == expected_calls(tcfg, "decode")


def test_reference_backend_runs_no_op():
    _, tcfg = _configs("jamba-v0.1-52b")
    tw = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    toks = torch.tensor(_inputs(tcfg, PROMPT + 1))
    _reset()
    _, st = prefill(tw, tcfg, {"tokens": toks[:, :PROMPT]},
                    init_serve_state(tcfg, B, PROMPT + 1, "cpu"),
                    backend="reference")
    decode_step(tw, tcfg, toks[:, PROMPT:], st, backend="reference")
    assert set(_calls().values()) == {0}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_backend_equals_kernel_backend_on_cpu(arch):
    """On the CPU both backends run the plain versions: bit-equal."""
    _, tcfg = _configs(arch)
    tw = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    toks = torch.tensor(_inputs(tcfg, PROMPT))
    out = {}
    for backend in ("cuda", "reference"):
        lg, st = prefill(tw, tcfg, {"tokens": toks},
                         init_serve_state(tcfg, B, PROMPT + 1, "cpu"),
                         backend=backend)
        lg2, _ = decode_step(tw, tcfg, toks[:, :1], st, backend=backend)
        out[backend] = (lg, lg2, st.cache)
    for a, b in zip(pytree.tree_leaves(out["cuda"]),
                    pytree.tree_leaves(out["reference"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_longer_prefill(arch):
    """The last logits of a prefill over p+1 tokens equal prefill(p) then
    decode(token p), through the Mamba (conv, ssm) cache and the KV cache
    of every virtual layer (the smoke configs are dropless), within 1e-5
    or 3x the port's own noise floor (the longer prefill again with
    perturbed weights)."""
    jcfg, tcfg = _configs(arch)
    w, dts = _np_weights(jcfg)
    toks = torch.tensor(_inputs(tcfg, PROMPT + 1))

    def longer(tw):
        return prefill(tw, tcfg, {"tokens": toks},
                       init_serve_state(tcfg, B, PROMPT + 1, "cpu"))[0]

    tw = _both(w, dts)[1]
    _, st = prefill(tw, tcfg, {"tokens": toks[:, :PROMPT]},
                    init_serve_state(tcfg, B, PROMPT + 1, "cpu"))
    a, _ = decode_step(tw, tcfg, toks[:, PROMPT:], st)
    b = longer(tw)
    moved = longer(_both(_perturbed(w, "f32"), dts)[1])
    _assert_within_floor(a, b.numpy(), moved, "f32", "self-consistency")


# ---------------------------------------------------------------------------
# init, caches and the launcher
# ---------------------------------------------------------------------------

def _paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_has_the_jax_packages_layout_and_dtypes(arch, dt):
    jcfg, tcfg = _configs(arch, True, dt)
    want = _paths(jax.eval_shape(
        lambda: jax_init_lm(jax.random.PRNGKey(0), jcfg)))
    got = init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    got_np = _paths(params_to_numpy(got))
    got_dt = _paths(jax.tree_util.tree_map(lambda t: str(t.dtype)
                                           .split(".")[-1], got))
    assert sorted(got_np) == sorted(want)
    for path, leaf in want.items():
        assert got_np[path].shape == leaf.shape, path
        assert got_dt[path] == str(leaf.dtype), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_has_the_jax_packages_layout(arch):
    jcfg, tcfg = _configs(arch)
    want = _paths(jax.eval_shape(lambda: jtf.init_cache(jcfg, B, 16)))
    got = _paths(params_to_numpy(ttf.init_cache(tcfg, B, 16, "cpu")))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape, path


def test_init_blocks_fills_each_stacked_leaf_period_by_period():
    """The stacked period holds what drawing the periods one after the
    other and stacking them would hold: same values, same draw order."""
    _, tcfg = _configs("deepseek-moe-16b")
    got = ttf.init_blocks(torch.Generator().manual_seed(5), tcfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    prelude = [ttf.init_layer(gen, tcfg, spec, "cpu", dense_d_ff=64)
               for spec in tcfg.prelude]
    periods = [materialize({f"sub{j}": ttf.layer_inits(gen, tcfg, spec,
                                                       "cpu")
                            for j, spec in enumerate(tcfg.period)})
               for _ in range(tcfg.n_periods)]
    want = {"prelude": prelude,
            "period": pytree.tree_map(lambda *xs: torch.stack(xs), *periods)}
    assert pytree.tree_structure(got) == pytree.tree_structure(want)
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["prelude"][0]["mlp"]["w_up"].shape == (64, 64)


def test_dense_init_is_scaled_in_place():
    from repro_torch.models.common import dense_init
    w = dense_init(torch.Generator().manual_seed(0), (16, 256, 32),
                   torch.float32, "cpu")
    assert float(w.abs().max()) <= 2.0 / 4 + 1e-6        # fan_in = 16
    assert abs(float(w.std()) - 0.88 / 4) < 0.02


def test_serve_takes_a_model_config(capsys):
    """A depth-cut config goes in as it is, as chip_smoke.py serves Jamba
    at 2 of its 4 periods."""
    cfg = dataclasses.replace(smoke_config("jamba-v0.1-52b"), n_periods=1)
    res = tserve.serve(cfg, prompt_len=8, decode_tokens=3, batch=2,
                       device="cpu")
    assert res.tokens.shape == (2, 3)
    assert res.tokens.min() >= 0 and res.tokens.max() < 256
    assert "arch=jamba-v0.1-52b-smoke batch=2 prompt=8" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b"])
def test_main_serves_the_moe_configs_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--prompt-len", "6", "--decode-tokens",
                 "2", "--batch", "2", "--device", "cpu"])
    assert f"arch={arch}-smoke batch=2 prompt=6 decode=2" in \
        capsys.readouterr().out
