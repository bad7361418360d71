"""The port's RMSNorm and flash-attention ops on CPU tensors against the
JAX package's.

On CPU tensors the port's ops run their plain versions (``ref.py``); the
CUDA kernels are held against those plain versions on the card by
``chip_smoke.py``. The same numpy inputs feed both packages.

- RMSNorm: against ``repro.kernels.rmsnorm.ops.rmsnorm(use_pallas=True)``
  (the Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
  and against ``repro.models.common.rmsnorm`` (what the JAX model calls).
- Flash attention: the Pallas kernel cannot run in interpret mode on this
  host (``requires_pallas_device``), so the oracles are the JAX package's
  ``attention_ref`` and, for causal attention, the function its model
  calls: ``attention._sdpa_direct`` with ``_mask_bias``.

Tolerances (elementwise |port - jax| <= atol + rtol * |jax|): f32 rtol
1e-5 / atol 1e-5 (the same math in another summation order); bf16 one
bf16 ulp relative (rtol 2**-7) with atol 1e-5, since both packages compute
in f32 and round once at the end, and an f32 difference at the last bit
may flip that rounding.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.rmsnorm import ops as jrn_ops
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.kernels import build, on_cuda, registry
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rn_kernel

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", ROOT / "chip_smoke.py")

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "bf16": dict(rtol=2.0 ** -7, atol=1e-5)}

# tests/test_kernels.py's RN_SHAPES, plus the qk-norm layout [B, S, H, dh]
# and a row count no power of two divides
RN_SHAPES = [(4, 128), (2, 7, 256), (1, 384), (3, 5, 64), (2, 3, 4, 16),
             (37, 2304)]
# tests/test_kernels.py's FA_CASES, plus ragged lengths, d=16 and Sq < Sk
FA_CASES = [
    # (B, Sq, Sk, H, KV, d, causal, window, softcap)
    (1, 128, 128, 4, 4, 64, True, 0, 0.0),      # MHA causal
    (2, 128, 128, 4, 2, 64, True, 0, 0.0),      # GQA 2:1
    (1, 256, 256, 8, 1, 64, True, 0, 0.0),      # MQA (granite kv=1)
    (1, 128, 128, 4, 4, 64, False, 0, 0.0),     # bidirectional
    (1, 256, 256, 4, 2, 64, True, 128, 0.0),    # sliding window (gemma2)
    (1, 128, 128, 4, 2, 64, True, 0, 50.0),     # softcap (gemma2)
    (2, 384, 384, 4, 2, 128, True, 256, 30.0),  # window+softcap, d=128
    (2, 37, 37, 4, 2, 16, True, 8, 50.0),       # smoke-config shapes
    (1, 100, 133, 4, 2, 32, False, 0, 0.0),     # Sq < Sk
]


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _pair(a, dt):
    """The same numpy array as a JAX and a torch CPU array of dtype dt."""
    return jnp.asarray(a).astype(JAX_DT[dt]), torch.tensor(a).to(TORCH_DT[dt])


def _close(port, want, dt):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dt])


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", RN_SHAPES, ids=str)
def test_rmsnorm_plain_matches_pallas_interpret(shape, dt):
    jx, tx = _pair(_np(shape, 1, 3.0), dt)
    js, ts = _pair(1.0 + _np(shape[-1:], 2, 0.1), dt)
    got = rn_ops.rmsnorm(tx, ts)
    assert got.dtype == TORCH_DT[dt] and got.shape == tx.shape
    _close(got, jrn_ops.rmsnorm(jx, js, use_pallas=True), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", RN_SHAPES[:3], ids=str)
def test_rmsnorm_plain_matches_jax_model_rmsnorm(shape, dt):
    jx, tx = _pair(_np(shape, 3, 2.0), dt)
    js, ts = _pair(1.0 + _np(shape[-1:], 4, 0.1), dt)
    _close(rn_ref.rmsnorm_ref(tx, ts), jcommon.rmsnorm({"scale": js}, jx),
           dt)


def test_rmsnorm_eps_is_passed_through():
    x = torch.tensor(_np((3, 16), 5, 1e-3))
    s = torch.ones(16)
    a, b = rn_ops.rmsnorm(x, s, eps=1e-6), rn_ops.rmsnorm(x, s, eps=1e-2)
    assert not torch.allclose(a, b)
    want = jrn_ops.rmsnorm(jnp.asarray(x.numpy()), jnp.ones(16), eps=1e-2)
    _close(b, want, "f32")


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(case, dt):
    b, sq, sk, h, kv, d = case[:6]
    return (_pair(_np((b, sq, h, d), 7), dt), _pair(_np((b, sk, kv, d), 8), dt),
            _pair(_np((b, sk, kv, d), 9), dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_plain_matches_jax_attention_ref(case, dt):
    causal, window, cap = case[6:]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dt)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = fa_ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TORCH_DT[dt] and got.shape == tq.shape
    _close(got, jfa_ref.attention_ref(jq, jk, jv, **kw), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", [c for c in FA_CASES if c[6] and c[1] == c[2]],
                         ids=str)
def test_flash_plain_matches_jax_model_sdpa(case, dt):
    """Causal attention as the JAX model computes it for a prompt: the
    direct grouped einsum with the causal (+ window) bias."""
    b, s, _, h, kv, d, _, window, cap = case
    (jq, tq), (jk, tk), (jv, tv) = _qkv(case, dt)
    jcfg = dataclasses.replace(jax_smoke_config("gemma2-2b"),
                               attn_softcap=cap)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = jattn._sdpa_direct(jcfg, jq, jk, jv,
                              jattn._mask_bias(pos, pos, window))
    got = fa_ops.flash_attention(tq, tk, tv, causal=True, window=window,
                                 softcap=cap)
    _close(got, want, dt)


def test_flash_first_causal_row_is_v0():
    """Causal row 0 attends only to itself => output == v[0] (the property
    tests/test_kernels.py holds the Pallas kernel to)."""
    q, k, v = (torch.tensor(_np((1, 64, 2, 32), s)) for s in (0, 1, 2))
    out = fa_ops.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out[:, 0], v[:, 0], rtol=1e-6, atol=1e-6)


def test_flash_plain_reads_strided_operands():
    """A transposed view (head dim contiguous) gives the same result as
    its contiguous copy — the layout the CUDA launcher reads by strides."""
    q = torch.tensor(_np((2, 4, 40, 16), 3)).transpose(1, 2)
    k = torch.tensor(_np((2, 2, 40, 16), 4)).transpose(1, 2)
    v = torch.tensor(_np((2, 2, 40, 16), 5)).transpose(1, 2)
    a = fa_ops.flash_attention(q, k, v, causal=True, window=5)
    b = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, window=5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernel's arithmetic (split P), on the CPU
# ---------------------------------------------------------------------------

# chip_smoke.py's flash cases that fit this host: at most 2^28
# multiply-adds per product (its larger ones run only on the card)
SPLIT_CASES = [c for c in SMOKE.FA_CASES
               if c[0] * c[1] * c[2] * c[3] * c[5] <= 2 ** 28]


def _split_p_attention(q, k, v, *, causal, window, softcap, split):
    """What the bf16 kernel computes, in plain torch: scores in f32 (the
    tensor cores' bf16 products are exact in the f32 sum), softcap and
    mask as ``ref.attention_ref``, P = exp(S - m) and its row sum l in f32,
    then P rounded to bf16 as P_hi (and, with ``split``, P_lo =
    bf16(P - P_hi) beside it) for (P_hi + P_lo).V in f32, divided by
    max(l, 1e-30) and rounded once to bf16."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (d ** -0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos, kpos = torch.arange(sq), torch.arange(sk)
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        keep &= kpos[None, :] > qpos[:, None] - window
    s = s.masked_fill(~keep, fa_ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    p_hi = p.to(torch.bfloat16).float()
    pv = p_hi + (p - p_hi).to(torch.bfloat16).float() if split else p_hi
    o = torch.einsum("bkgqs,bskd->bqkgd", pv / denom, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def _excess(got, want, rtol):
    """max(|got - want| - rtol |want|): the least atol the pair needs."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() - rtol * w.abs()).max())


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_flash_split_p_meets_the_bf16_bar(case):
    """P as bf16 hi + lo (~16 bits) keeps the bf16 kernel within
    chip_smoke.py's FA_TOL["bfloat16"] of the plain version."""
    rtol, atol = SMOKE.FA_TOL["bfloat16"]
    (_, tq), (_, tk), (_, tv) = _qkv(case, "bf16")
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    got = _split_p_attention(tq, tk, tv, split=True, **kw)
    want = fa_ref.attention_ref(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(
        got.float()).all())
    assert _excess(got, want, rtol) <= atol


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_flash_single_bf16_p_fails_the_bf16_bar(case):
    """One bf16 rounding of P (as SDPA multiplies P.V) moves outputs by
    ~2^-9 relative: beyond FA_TOL["bfloat16"]'s atol, hence the split."""
    rtol, atol = SMOKE.FA_TOL["bfloat16"]
    (_, tq), (_, tk), (_, tv) = _qkv(case, "bf16")
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    got = _split_p_attention(tq, tk, tv, split=False, **kw)
    want = fa_ref.attention_ref(tq, tk, tv, **kw)
    assert _excess(got, want, rtol) > atol


def test_flash_split_cases_cover_the_new_tile_edges():
    """The CPU cases include the 128-row tiles' edges chip_smoke.py adds:
    one query over 1024 keys and 129 rows."""
    shapes = {c[:3] for c in SPLIT_CASES}
    assert (2, 1, 1024) in shapes and (2, 129, 129) in shapes
    assert len(SPLIT_CASES) >= 12


def test_flash_launcher_checks_tma_alignment():
    """The bf16 kernel's TMA loads need 16-byte aligned bases and strides;
    the launcher raises on anything else instead of copying."""
    fa_kernel._check_tma_alignment(
        torch.empty(2, 8, 4, 64, dtype=torch.bfloat16), "q", 64)
    # a transposed view and a size-1 head dim are fine
    fa_kernel._check_tma_alignment(torch.empty(
        2, 4, 8, 64, dtype=torch.bfloat16).transpose(1, 2), "q", 64)
    fa_kernel._check_tma_alignment(
        torch.empty(2, 8, 1, 16, dtype=torch.bfloat16), "k", 16)
    buf = torch.empty(2 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa_kernel._check_tma_alignment(buf[1:].view(2, 8, 4, 64), "q", 64)
    wide = torch.empty(2, 8, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fa_kernel._check_tma_alignment(wide, "v", 64)
    assert fa_kernel._strides(
        torch.empty(1, 8, 1, 32, dtype=torch.bfloat16), 32) == [32, 32, 32]


# ---------------------------------------------------------------------------
# dispatch, launch counts, registry, build
# ---------------------------------------------------------------------------

def test_ops_count_one_call_each_on_cpu_and_launch_nothing():
    rn_ops.reset_op_calls()
    fa_ops.reset_op_calls()
    rn_kernel.reset_launches()
    fa_kernel.reset_launches()
    x = torch.ones(2, 3, 16)
    rn_ops.rmsnorm(x, torch.ones(16))
    rn_ops.rmsnorm(x, torch.ones(16))
    fa_ops.flash_attention(x[:, :, None], x[:, :, None], x[:, :, None])
    assert rn_ops.OP_CALLS == {"rmsnorm": 2}
    assert fa_ops.OP_CALLS == {"flash_attention": 1}
    assert rn_kernel.LAUNCHES == {"rmsnorm": 0}
    assert fa_kernel.LAUNCHES == {"flash_attention": 0}


def test_launchers_refuse_cpu_tensors():
    """No silent fallback: a launcher only takes CUDA tensors."""
    with pytest.raises(ValueError, match="CUDA"):
        rn_kernel.rmsnorm_call(torch.ones(2, 8), torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_call(*(torch.ones(1, 4, 2, 16),) * 3)


@pytest.mark.parametrize("op", ["rmsnorm", "flash_attention"])
def test_ops_refuse_a_device_with_no_kernel_or_plain_version(op):
    x = torch.ones(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        if op == "rmsnorm":
            rn_ops.rmsnorm(x, torch.ones(16, device="meta"))
        else:
            fa_ops.flash_attention(x, x, x)
    assert not on_cuda(op, torch.device("cpu"))
    assert on_cuda(op, torch.device("cuda"))


@pytest.mark.parametrize("op", ["flash_attention.flash_attention",
                                "rmsnorm.rmsnorm"])
def test_registry_lists_the_serving_ops_as_forward_only(op):
    reason = registry.no_reverse_reason(op)
    assert reason is not None and "serving path only" in reason


# what each source must hold beyond its note: RMSNorm's 16-byte vectors
# with the row in registers and the scalar kernel kept for the widths
# they cannot take; flash's wgmma products, TMA loads by mbarrier, the
# descriptor built through the runtime's driver entry point (no -lcuda),
# the register rebalancing, and the f32 CUDA-core kernel
SOURCE_PARTS = {
    "rmsnorm": ("rmsnorm_vec_kernel", "uint4",
                "__global__ void rmsnorm_kernel"),
    "flash_attention": ("wgmma.mma_async.sync.aligned",
                        "cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                        "cuTensorMapEncodeTiled", "__grid_constant__",
                        "setmaxnreg", "flash_tc_kernel", "flash_fwd_kernel"),
}


@pytest.mark.parametrize("name,tpu_ref", [
    ("rmsnorm", "src/repro/kernels/rmsnorm/rmsnorm.py _rmsnorm_kernel (:19)"),
    ("flash_attention",
     "flash_attention.py _flash_kernel (:31)")])
def test_cuda_source_is_hand_written_and_names_the_tpu_kernel(name, tpu_ref):
    src = build.source_path(name)
    assert src.is_file()
    text = src.read_text()
    head = text.split("#include")[0]
    assert " ".join(tpu_ref.split()) in " ".join(head.split())
    assert "Bound:" in head and "Design" in head
    assert "cudaGetLastError()" in text
    for part in SOURCE_PARTS[name]:
        assert part in text
    for banned in ("cublas", "cudnn", "scaled_dot_product", "torch/"):
        assert banned not in text.lower()
    py = "".join(p.read_text() for p in src.parents[1].glob("*.py"))
    for banned in ("scaled_dot_product_attention", "torch.compile",
                   "rms_norm("):
        assert banned not in py


def test_nvcc_flags_per_source():
    """The ALF kernels repeat their plain version bit for bit and build
    without FMA contraction; the LM kernels use the default."""
    assert "--fmad=false" in build.nvcc_flags("alf_step")
    for name in ("rmsnorm", "flash_attention"):
        flags = build.nvcc_flags(name)
        assert "--fmad=false" not in flags
        # wgmma and setmaxnreg exist only for the "a" target
        assert "arch=compute_90a,code=sm_90a" in flags
        # the TMA descriptor comes through cudaGetDriverEntryPoint
        assert not any(f.startswith("-l") for f in flags)
    paths = {build.library_path(n) for n in
             ("alf_step", "rmsnorm", "flash_attention")}
    assert len(paths) == 3
    assert all(re.fullmatch(r"\w+-[0-9a-f]{16}", p.parent.name)
               for p in paths)
