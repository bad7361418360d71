"""The port's roofline and op cost counter (``repro_torch.launch.roofline``
and ``launch/cost.py``) on the CPU: the roofline's terms at the H100's
rates, the ring wire multipliers against the JAX package's, the counter
against closed forms for a product, a pointwise op, a reduction and a
cast, each kernel op's declared work against the closed forms behind
PERF.md's section 6 bounds (and the same on meta and CPU tensors), and
one smoke-config prefill, decode and train step counted on meta equal to
the same step counted on CPU tensors."""
import dataclasses

import pytest
import torch

from repro.launch.roofline import _wire_multiplier as jax_wire_multiplier
from repro_torch.configs import DEFAULT_ODE, smoke_config
from repro_torch.kernels.alf_step import ops as alf_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.launch import specs
from repro_torch.launch.cost import OpCounter, count, count_kernel_launches
from repro_torch.launch.roofline import (CARDS, H100, CollectiveStats,
                                         Roofline, _wire_multiplier,
                                         card_rates, compute_seconds,
                                         model_flops_estimate)

torch.set_num_threads(1)


def test_roofline_math():
    """One second each of bf16 tensor-core FLOPs at 989e12, of f32 FLOPs
    at 67e12 and of bytes at 3.35e12; the collective term is not
    reckoned."""
    bf16 = Roofline(flops=989e12, flops_bf16=989e12, hbm_bytes=3.35e12,
                    coll=CollectiveStats(), chips=256,
                    model_flops=989e12 * 256)
    d = bf16.to_dict()
    assert d["t_compute_s"] == pytest.approx(1.0, rel=1e-12)
    assert d["t_memory_s"] == pytest.approx(1.0, rel=1e-12)
    assert d["t_collective_s"] is None
    assert "item 13" in d["t_collective_reason"]
    assert d["useful_flops_ratio"] == pytest.approx(1.0)
    f32 = Roofline(flops=67e12, hbm_bytes=0.0, coll=CollectiveStats(),
                   chips=1)
    assert f32.t_compute == pytest.approx(1.0, rel=1e-12)
    assert f32.bottleneck == "compute"
    both = Roofline(flops=989e12 + 67e12, flops_bf16=989e12,
                    hbm_bytes=3.35e12 * 3, coll=CollectiveStats(), chips=1)
    assert both.t_compute == pytest.approx(2.0)
    assert both.t_bound == pytest.approx(3.0)
    assert both.bottleneck == "memory"
    assert compute_seconds({"bf16": 989e12, "f32": 67e12}) == \
        pytest.approx(2.0)
    # the JAX record's keys, plus the port's
    from repro.launch.roofline import CollectiveStats as JaxStats
    from repro.launch.roofline import Roofline as JaxRoofline
    jax_keys = set(JaxRoofline(1.0, 1.0, JaxStats(), 1).to_dict())
    assert jax_keys <= set(d)


def test_card_table():
    assert card_rates("NVIDIA H100 80GB HBM3") == H100 == (3.35e12, 67e12,
                                                            989e12)
    assert card_rates("NVIDIA H100 PCIe").hbm == 2.0e12
    assert card_rates("NVIDIA H100 NVL").bf16 == 835e12
    assert card_rates("NVIDIA H200").hbm == 4.8e12
    assert [k for k, _ in CARDS][-1] == "H100"     # the bare name last
    with pytest.raises(KeyError):
        card_rates("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 16, 32])
def test_wire_multipliers_match_jax(kind, group):
    assert _wire_multiplier(kind, group) == jax_wire_multiplier(kind, group)


def test_collective_stats_sum_wire_bytes():
    c = CollectiveStats()
    c.add("all-reduce", "model", 16, 1000.0)
    c.add("all-gather", "data", 16, 1600.0)
    assert c.wire_bytes_per_chip == pytest.approx(1000 * 30 / 16
                                                  + 1600 * 15 / 16)
    assert c.op_counts == {"all-reduce": 1, "all-reduce@model": 1,
                           "all-gather": 1, "all-gather@data": 1}


def test_model_flops_estimate_matches_jax():
    from repro.configs.base import ShapeCell as JaxCell
    from repro.launch.roofline import model_flops_estimate as jax_estimate
    for cell in (JaxCell("t", 4096, 256, "train"),
                 JaxCell("p", 32768, 32, "prefill"),
                 JaxCell("d", 32768, 128, "decode")):
        assert model_flops_estimate(None, cell, 1.7e9, 3) == \
            jax_estimate(None, cell, 1.7e9, 3)


# --------------------------------------------------------------------------
# The counter against closed forms
# --------------------------------------------------------------------------

def _counted(fn, *args):
    with OpCounter() as c:
        fn(*args)
    return c


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_counter_closed_forms(device):
    m, k, n = 8, 16, 4
    a = torch.ones((m, k), device=device)
    b = torch.ones((k, n), device=device)
    c = _counted(torch.mm, a, b)                     # a product
    assert (c.flops, c.flops_bf16) == (2 * m * k * n, 0)
    assert c.bytes == (m * k + k * n + m * n) * 4
    c = _counted(torch.mm, a.bfloat16(), b.bfloat16())
    assert c.flops_bf16 == c.flops == 2 * m * k * n
    assert c.bytes == (m * k + k * n + m * n) * 2
    c = _counted(torch.add, a, a)                    # pointwise
    assert (c.flops, c.bytes) == (m * k, 3 * m * k * 4)
    c = _counted(lambda x: x.sum(1), a)              # a reduction
    assert (c.flops, c.bytes) == (m * k, (m * k + m) * 4)
    c = _counted(lambda x: x.to(torch.bfloat16), a)  # a cast: bytes only
    assert (c.flops, c.bytes) == (0, m * k * (4 + 2))
    c = _counted(lambda x: x.t()[:3].unsqueeze(0).expand(2, 3, k), b)
    assert (c.flops, c.bytes, c.n_ops) == (0, 0, 0)      # views are free
    c = _counted(lambda x: x.t().reshape(-1), b)   # a reshape that copies
    assert c.flops == 0 and c.bytes >= 2 * k * n * 4


def test_counter_sees_the_backward():
    x = torch.ones((4, 3), requires_grad=True)
    w = torch.ones((3, 2), requires_grad=True)
    with OpCounter() as c:
        (x @ w).sum().backward()
    # forward mm, backward two mm
    assert c.by_op["aten.mm"][0] == 3
    assert c.by_op["aten.mm"][1] == 3 * 2 * 4 * 3 * 2


# --------------------------------------------------------------------------
# Each kernel op's declared work: the closed forms of PERF.md's bounds
# --------------------------------------------------------------------------

# (buffers read, buffers written, f32 operations an element): PERF.md
# section 6's ALF rows
ALF_TABLE = {"alf_midpoint": (2, 1, 3), "alf_update": (3, 2, 5),
             "alf_bwd_pre": (4, 2, 5), "alf_bwd_post": (6, 4, 12),
             "alf_midpoint_vjp": (1, 1, 2), "alf_update_vjp": (2, 2, 4),
             "alf_inverse": (3, 2, 7), "alf_inverse_update": (3, 2, 5)}
# PERF.md section 6's bounds in ms (H100): at 2048 x 64 f32, and the
# midpoint at 2^25
ALF_BOUND_MS = {"alf_midpoint": 0.00047, "alf_update": 0.00078,
                "alf_bwd_pre": 0.00094, "alf_bwd_post": 0.00157,
                "alf_midpoint_vjp": 0.00031, "alf_update_vjp": 0.00063,
                "alf_inverse": 0.00078, "alf_inverse_update": 0.00078}


def _ms(work):
    """A work's bound in ms on the H100."""
    return max(compute_seconds({work.flop_class: work.flops}),
               work.bytes / H100.hbm) * 1e3


@pytest.mark.parametrize("name", sorted(ALF_TABLE))
def test_alf_work_is_the_bound_formula(name):
    n_in, n_out, ops = ALF_TABLE[name]
    for n, dtype in ((2048 * 64, torch.float32), (1 << 25, torch.float32),
                     (1000, torch.bfloat16)):
        buf = torch.empty(n, dtype=dtype, device="meta")
        w = alf_ops.alf_work(name, buf, torch.empty((), device="meta"))
        assert w == (ops * n, (n_in + n_out) * n * buf.element_size(),
                     "f32")
    # a per-row (B,) h is read once too
    w = alf_ops.alf_work(name, torch.empty(64, device="meta"),
                         torch.empty(8, device="meta"))
    assert w.bytes == (n_in + n_out) * 64 * 4 + 8 * 4
    buf = torch.empty(2048 * 64, device="meta")
    assert _ms(alf_ops.alf_work(name, buf, torch.empty(()))) == \
        pytest.approx(ALF_BOUND_MS[name], rel=0.02)
    big = torch.empty(1 << 25, device="meta")
    if name == "alf_midpoint":
        assert _ms(alf_ops.alf_work(name, big, torch.empty(()))) == \
            pytest.approx(0.1202, rel=1e-3)


def test_rmsnorm_work_is_the_bound_formula():
    n, d = 4 * 1024, 2048                      # qwen3-1.7b's prefill rows
    x = torch.empty((n, d), dtype=torch.bfloat16, device="meta")
    s = torch.empty((d,), dtype=torch.bfloat16, device="meta")
    w = rn_ops.rmsnorm_work(x, s)
    assert w == (4 * n * d, (2 * n * d + d) * 2, "f32")
    assert _ms(w) == pytest.approx(0.0100, rel=5e-3)


@pytest.mark.parametrize("shape,bound_ms", [
    ((4, 1024, 16, 8, 128), 0.0174),   # qwen3-1.7b (operations)
    ((4, 1024, 32, 32, 64), 0.0200),   # stablelm-1.6b (bytes)
    ((4, 1024, 48, 1, 128), 0.0522),   # granite-20b, MQA (operations)
    ((4, 1024, 8, 4, 256), 0.0174),    # gemma2-2b at d 256
])
def test_flash_work_is_the_bound_formula(shape, bound_ms):
    b, s, h, kv, d = shape
    q = torch.empty((b, s, h, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, s, kv, d), dtype=torch.bfloat16, device="meta")
    w = fa_ops.flash_attention_work(q, k, True, 0)
    pairs = b * h * s * (s + 1) // 2
    assert w == (4 * pairs * d, (2 * b * s * h * d + 2 * b * s * kv * d) * 2,
                 "bf16")
    assert _ms(w) == pytest.approx(bound_ms, rel=5e-3)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (7, 7, True, 0), (5, 9, True, 0), (9, 5, True, 0), (6, 6, False, 0),
    (10, 10, True, 3), (4, 11, False, 2), (12, 4, True, 5)])
def test_unmasked_pairs_counts_the_mask(sq, sk, causal, window):
    want = sum(1 for i in range(sq) for j in range(sk)
               if (not causal or j <= i)
               and (window <= 0 or j > i - window))
    assert fa_ops.unmasked_pairs(sq, sk, causal, window) == want


def test_scan_work_is_the_bound_formula():
    bt, s, di, st = 4, 1024, 8192, 16          # Jamba's prefill
    delta = torch.empty((bt, s, di), device="meta")
    u = torch.empty((bt, s, di), dtype=torch.bfloat16, device="meta")
    a = torch.empty((di, st), device="meta")
    bc = torch.empty((bt, s, st), dtype=torch.bfloat16, device="meta")
    w = ms_ops.selective_scan_work(delta, u, a, bc, bc)
    n = bt * s * di
    assert w.flops == 7 * n * st + n == pytest.approx(3.79e9, rel=1e-3)
    assert w.bytes == pytest.approx(340.5e6, rel=1e-3)
    assert w.bytes / H100.hbm * 1e3 == pytest.approx(0.1016, rel=1e-3)
    assert w.flops / H100.f32 * 1e3 == pytest.approx(0.0566, rel=1e-3)


def _kernel_op_calls(device):
    gen = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.float32):
        x = torch.randn(shape, generator=gen).to(dtype)
        return x if device == "cpu" else torch.empty_like(x, device="meta")
    h = 0.1 if device == "cpu" else torch.full((), 0.1, device="meta")
    z, v, u = t(6, 5), t(6, 5), t(6, 5)
    return {
        "alf_midpoint": lambda: alf_ops.alf_midpoint(z, v, h),
        "alf_update": lambda: alf_ops.alf_update(z, v, u, h),
        "alf_bwd_pre": lambda: alf_ops.alf_bwd_pre(z, v, u, z, h),
        "alf_bwd_post": lambda: alf_ops.alf_bwd_post(z, v, u, z, v, u, h),
        "alf_inverse": lambda: alf_ops.alf_inverse(z, v, u, h),
        "alf_inverse_update": lambda: alf_ops.alf_inverse_update(z, v, u, h),
        "rmsnorm": lambda: rn_ops.rmsnorm(t(3, 7, dtype=torch.bfloat16),
                                          t(7)),
        "flash_attention": lambda: fa_ops.flash_attention(
            t(2, 9, 4, 16), t(2, 9, 2, 16), t(2, 9, 2, 16), window=4),
        "selective_scan": lambda: ms_ops.selective_scan(
            t(2, 5, 8), t(2, 5, 8), t(8, 4), t(2, 5, 4), t(2, 5, 4)),
    }


def test_kernel_ops_count_their_declared_work_on_meta_and_cpu():
    got = {}
    for device in ("cpu", "meta"):
        for name, call in _kernel_op_calls(device).items():
            c = _counted(call)
            row = c.kernels[name]
            assert row[0] == 1, (name, device)
            # nothing inside the op is counted on top of its work
            assert not any(k.startswith("aten._softmax") or
                           k == "aten.exp" for k in c.by_op), name
            got.setdefault(name, []).append((row, c.flops, c.bytes))
    for name, (cpu, meta) in got.items():
        assert cpu == meta, name


def test_reverse_rules_count_their_kernels():
    z = torch.randn(6, 5, requires_grad=True)
    v = torch.randn(6, 5, requires_grad=True)
    u = torch.randn(6, 5, requires_grad=True)
    with OpCounter() as c:
        zo, vo = alf_ops.alf_update(alf_ops.alf_midpoint(z, v, 0.1), v, u,
                                    0.1)
        (zo.sum() + vo.sum()).backward()
    for name in ("alf_midpoint", "alf_update", "alf_midpoint_vjp",
                 "alf_update_vjp"):
        assert c.kernels[name][0] == 1, name
    assert c.kernels["alf_update_vjp"][1] == 4 * 30


def test_count_kernel_launches():
    z, v = torch.randn(6), torch.randn(6)
    assert count_kernel_launches(alf_ops.alf_midpoint, z, v, 0.1) == 1
    assert count_kernel_launches(
        lambda: [alf_ops.alf_update(z, v, v, 0.1) for _ in range(3)],
        by_op=True) == {"alf_update": 3}


# --------------------------------------------------------------------------
# A smoke-config step counted on meta and on CPU tensors
# --------------------------------------------------------------------------

def _step(kind, device):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import decode_step, init_lm, prefill
    from repro_torch.models.lm import init_serve_state
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state
    cfg = smoke_config("qwen3-1.7b",
                       dataclasses.replace(DEFAULT_ODE, backend="cuda"))
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    params = (init_lm(gen, cfg, dev) if device == "cpu"
              else specs.param_specs(cfg))

    def ints(*shape):
        x = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                          dtype=torch.int32)
        return x if device == "cpu" else torch.empty_like(x, device=dev)
    if kind == "train":
        oc = OptimizerConfig()
        step = make_train_step(cfg, oc)
        opt = init_opt_state(oc, params)
        batch = {"tokens": ints(2, 16), "labels": ints(2, 16)}
        return lambda: step(params, opt, batch)
    state = init_serve_state(cfg, 2, 24, dev)
    with torch.no_grad():
        _, state = prefill(params, cfg, {"tokens": ints(2, 16)}, state)
    if kind == "prefill":
        state = init_serve_state(cfg, 2, 24, dev)
        return lambda: prefill(params, cfg, {"tokens": ints(2, 16)}, state)
    return lambda: decode_step(params, cfg, ints(2, 1), state)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_step_counts_equal_on_meta_and_cpu(kind):
    got = []
    for device in ("cpu", "meta"):
        run = _step(kind, device)
        with (torch.no_grad() if kind != "train" else torch.enable_grad()):
            _, c = count(run)
        got.append((c.flops, c.flops_bf16, c.bytes, c.n_ops,
                    {k: tuple(v) for k, v in c.kernels.items()},
                    {k: tuple(v) for k, v in c.by_op.items()}))
        assert c.flops > 0 and c.bytes > 0
    assert got[0] == got[1]
    names = set(got[0][4])
    assert {"rmsnorm", "alf_midpoint", "alf_update"} <= names \
        if kind != "train" else {"alf_bwd_pre", "alf_bwd_post"} <= names
