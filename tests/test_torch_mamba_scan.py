"""The port's selective-scan op on CPU tensors against the JAX package's.

On CPU tensors the op runs its plain version (``ref.py``); the CUDA kernel
is held against that plain version on the card by ``chip_smoke.py``. The
same numpy inputs feed both packages, made as tests/test_kernels.py makes
them (delta = softplus(normal), A = -exp(0.3 normal)).

Tolerances (elementwise |port - jax| <= atol + rtol * |jax|), y and the
final state h both compared:

- against the JAX package's ``selective_scan_ref``, in f32 and with bf16
  inputs (both convert the inputs to f32 and run the same recurrence in
  the same operation order): h to rtol 1e-5 / atol 1e-6. y to rtol 1e-5 /
  atol 1e-5, because its ST-term sum is taken in another order (JAX's
  einsum, torch's reduction): where terms of magnitude up to ~50 cancel
  to a y near 0, the two differ by up to 1.1e-6 beyond rtol (measured over
  these cases), a few ulps of the terms;
- against the Pallas kernel in interpret mode: the bar
  tests/test_kernels.py holds that kernel to, 2e-4 / 2e-4 in f32 and
  3e-2 / 3e-2 with bf16 inputs.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ops as jms_ops
from repro.kernels.mamba_scan import ref as jms_ref
from repro_torch.kernels import PACKAGES, build, on_cuda, registry
from repro_torch.kernels.mamba_scan import mamba_scan as ms_kernel
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan import ref as ms_ref

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
REF_TOL = dict(rtol=1e-5, atol=1e-6)           # h
REF_TOL_Y = dict(rtol=1e-5, atol=1e-5)         # y: the ST-term sum's order
PALLAS_TOL = {"f32": dict(rtol=2e-4, atol=2e-4),
              "bf16": dict(rtol=3e-2, atol=3e-2)}
# tests/test_kernels.py's MS_CASES: (Bt, S, DI, ST)
MS_CASES = [
    (1, 16, 128, 16),
    (2, 33, 256, 16),     # odd seq
    (1, 8, 200, 8),       # DI not a multiple of the block
    (2, 64, 512, 4),
]


def _inputs(case, seed=11):
    """delta, u, A, B, C as f32 numpy."""
    bt, s, di, st = case
    rng = np.random.default_rng(seed)
    f32 = np.float32
    delta = np.logaddexp(rng.standard_normal((bt, s, di)), 0.0).astype(f32)
    u = rng.standard_normal((bt, s, di)).astype(f32)
    a = -np.exp(0.3 * rng.standard_normal((di, st))).astype(f32)
    b = rng.standard_normal((bt, s, st)).astype(f32)
    c = rng.standard_normal((bt, s, st)).astype(f32)
    return delta, u, a, b, c


def _both(arrays, dts):
    """The same numpy arrays as JAX and torch CPU arrays, each cast to its
    dtype ("f32" or "bf16"); A stays f32, as the model passes it."""
    jx = [jnp.asarray(x).astype(JAX_DT[d]) for x, d in zip(arrays, dts)]
    tx = [torch.tensor(x).to(TORCH_DT[d]) for x, d in zip(arrays, dts)]
    return jx, tx


def _dtypes(dt):
    return (dt, dt, "f32", dt, dt)


def _close(port, want, tol):
    assert port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), np.asarray(want, np.float32),
                               **tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", MS_CASES, ids=str)
def test_scan_matches_jax_ref(case, dt):
    (jd, ju, ja, jb, jc), (td, tu, ta, tb, tc) = _both(_inputs(case),
                                                        _dtypes(dt))
    y, h = ms_ops.selective_scan(td, tu, ta, tb, tc)
    want_y, want_h = jms_ref.selective_scan_ref(jd, ju, ja, jb, jc)
    assert tuple(y.shape) == case[:3] and tuple(h.shape) == (
        case[0], case[2], case[3])
    # on the CPU the op is the port's plain version, bit for bit
    for a, b in zip((y, h), ms_ref.selective_scan_ref(td, tu, ta, tb, tc)):
        assert torch.equal(a, b)
    _close(y, want_y, REF_TOL_Y)
    _close(h, want_h, REF_TOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", MS_CASES, ids=str)
def test_scan_matches_pallas_interpret(case, dt):
    (jd, ju, ja, jb, jc), (td, tu, ta, tb, tc) = _both(_inputs(case),
                                                        _dtypes(dt))
    y, h = ms_ops.selective_scan(td, tu, ta, tb, tc)
    want_y, want_h = jms_ops.selective_scan(jd, ju, ja, jb, jc,
                                            use_pallas=True, interpret=True)
    _close(y, want_y, PALLAS_TOL[dt])
    _close(h, want_h, PALLAS_TOL[dt])


def test_scan_with_the_models_dtypes_matches_jax_ref():
    """delta f32, u/B/C bf16, A f32: what the Mamba prefill passes."""
    arrays = _inputs((2, 40, 96, 16), seed=3)
    (jd, ju, ja, jb, jc), (td, tu, ta, tb, tc) = _both(
        arrays, ("f32", "bf16", "f32", "bf16", "bf16"))
    y, h = ms_ops.selective_scan(td, tu, ta, tb, tc)
    want_y, want_h = jms_ref.selective_scan_ref(jd, ju, ja, jb, jc)
    _close(y, want_y, REF_TOL_Y)
    _close(h, want_h, REF_TOL)


def test_scan_carries_initial_state():
    """Split scan == full scan (the chunked-prefill invariant of
    tests/test_kernels.py): the plain version takes the same steps either
    way, so the two are bit-equal; and h0 is the JAX package's h0."""
    case = (1, 12, 128, 8)
    arrays = _inputs(case, seed=12)
    h0_np = np.random.default_rng(13).standard_normal(
        (1, 128, 8)).astype(np.float32)
    (jd, ju, ja, jb, jc), (d, u, a, b, c) = _both(arrays, _dtypes("f32"))
    h0 = torch.tensor(h0_np)
    y_full, h_full = ms_ops.selective_scan(d, u, a, b, c, h0)
    y1, h1 = ms_ops.selective_scan(d[:, :6], u[:, :6], a, b[:, :6],
                                   c[:, :6], h0)
    y2, h2 = ms_ops.selective_scan(d[:, 6:], u[:, 6:], a, b[:, 6:],
                                   c[:, 6:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y_full)
    assert torch.equal(h2, h_full)
    want_y, want_h = jms_ref.selective_scan_ref(jd, ju, ja, jb, jc,
                                                jnp.asarray(h0_np))
    _close(y_full, want_y, REF_TOL_Y)
    _close(h_full, want_h, REF_TOL)


def test_scan_of_length_zero_returns_h0():
    h0 = torch.randn(2, 16, 4)
    y, h = ms_ops.selective_scan(torch.ones(2, 0, 16), torch.ones(2, 0, 16),
                                 -torch.ones(16, 4), torch.ones(2, 0, 4),
                                 torch.ones(2, 0, 4), h0)
    assert tuple(y.shape) == (2, 0, 16)
    assert torch.equal(h, h0)


def test_scan_reads_strided_operands():
    """B and C as slices of one projection (the Mamba prefill's layout),
    delta and u as transposed views: the same result as contiguous
    copies — the layout the CUDA launcher reads by strides."""
    bt, s, di, st = 2, 20, 48, 8
    d, u, a, b, c = (torch.tensor(x) for x in _inputs((bt, s, di, st), 4))
    proj = torch.cat([torch.randn(bt, s, 5), b, c], -1)
    b_view, c_view = proj[..., 5:5 + st], proj[..., 5 + st:]
    d_view = d.transpose(1, 2).contiguous().transpose(1, 2)
    assert not (b_view.is_contiguous() or d_view.is_contiguous())
    got = ms_ops.selective_scan(d_view, u, a, b_view, c_view)
    want = ms_ops.selective_scan(d, u, a, b, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic (states split across a lane group), on the CPU
# ---------------------------------------------------------------------------

# states each lane of the kernel holds (kLaneStates in csrc/mamba_scan.cu)
LANE_STATES = 8
# this file's MS_CASES and chip_smoke.py's scan cases that fit this host:
# at most 2^16 states per step
LANE_CASES = MS_CASES + [c for c in SMOKE.MS_CASES
                         if c[0] * c[2] * c[3] <= 2 ** 16
                         and c not in MS_CASES]


def _kernel_lanes(st):
    """Lanes per (batch, channel) in the kernel: ST / kLaneStates above
    kLaneStates states, else one."""
    return st // LANE_STATES if st > LANE_STATES else 1


def _lane_group_scan(delta, u, A, B, C, lanes):
    """What the kernel computes, in plain torch: h as ``ref.py`` updates it
    (elementwise, the same operations in the same order), and y per step
    as the kernel sums it: each of ``lanes`` lanes takes ST / lanes
    consecutive states and forms its partial sum of h * C with fmaf from
    0 (emulated: the product is exact in f64, the f64 sum is rounded to
    f32; a double rounding can differ from fmaf's single one by an ulp),
    then the group adds its partials as a halving tree, lanes (l,
    l + lanes/2) first, as the reduce-scatter over __shfl_xor_sync
    does."""
    bt, s, di = delta.shape
    st = A.shape[1]
    per = st // lanes
    d, uf = delta.float(), u.float()
    a, bm, cm = A.float(), B.float(), C.float()
    h = torch.zeros((bt, di, st), dtype=torch.float32)
    y = torch.empty((bt, s, di), dtype=torch.float32)
    for t in range(s):
        dt = d[:, t]
        dA_t = torch.exp(dt[..., None] * a)
        dBu_t = (dt * uf[:, t])[..., None] * bm[:, t, None, :]
        h = dA_t * h + dBu_t
        hc = h.double().reshape(bt, di, lanes, per)
        cc = cm[:, t].double().reshape(bt, 1, lanes, per)
        part = torch.zeros((bt, di, lanes), dtype=torch.float32)
        for k in range(per):
            part = (part.double() + hc[..., k] * cc[..., k]).float()
        while part.shape[-1] > 1:
            half = part.shape[-1] // 2
            part = part[..., :half] + part[..., half:]
        y[:, t] = part[..., 0]
    return y, h


def test_lane_rule_matches_the_cuda_source():
    text = build.source_path("mamba_scan").read_text()
    found = re.search(r"constexpr int kLaneStates = (\d+);", text)
    assert found and int(found.group(1)) == LANE_STATES
    assert [_kernel_lanes(st) for st in ms_kernel.STATE_DIMS] == [
        1, 1, 1, 1, 2, 4]


def test_lane_cases_cover_the_lane_groups_edges():
    """Every state size the kernel is built for, one and several lanes a
    channel, DI off the blocks (128 channels at one lane, 32 at four) and
    S off the 16-step chunk."""
    assert {c[3] for c in LANE_CASES} == set(ms_kernel.STATE_DIMS)
    assert any(c[2] % 128 and _kernel_lanes(c[3]) == 1 for c in LANE_CASES)
    assert any(c[2] % 32 and _kernel_lanes(c[3]) == 4 for c in LANE_CASES)
    assert any(c[1] % 16 for c in LANE_CASES)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", LANE_CASES, ids=str)
def test_lane_group_scan_meets_the_scan_bar(case, dt):
    """The kernel's split of the states over 1, 2 or 4 lanes keeps y
    within chip_smoke.py's MS_TOL of the plain version and h bit-equal to
    it."""
    lanes = _kernel_lanes(case[3])
    rtol, atol = SMOKE.MS_TOL
    td, tu, ta, tb, tc = (torch.tensor(x).to(TORCH_DT[d]) for x, d in
                          zip(_inputs(case, seed=21), _dtypes(dt)))
    y, h = _lane_group_scan(td, tu, ta, tb, tc, lanes)
    want_y, want_h = ms_ref.selective_scan_ref(td, tu, ta, tb, tc)
    assert torch.equal(h, want_h)
    assert bool(torch.isfinite(y).all())
    excess = ((y.double() - want_y.double()).abs()
              - rtol * want_y.double().abs())
    assert float(excess.max()) <= atol


# ---------------------------------------------------------------------------
# dispatch, launch counts, registry, build
# ---------------------------------------------------------------------------

def test_op_counts_calls_on_cpu_and_launches_nothing():
    ms_ops.reset_op_calls()
    ms_kernel.reset_launches()
    d, u, a, b, c = (torch.tensor(x) for x in _inputs((1, 3, 8, 4)))
    ms_ops.selective_scan(d, u, a, b, c)
    ms_ops.selective_scan(d, u, a, b, c, torch.zeros(1, 8, 4))
    assert ms_ops.OP_CALLS == {"selective_scan": 2}
    assert ms_kernel.LAUNCHES == {"selective_scan": 0}
    ms_ops.reset_op_calls()
    assert ms_ops.OP_CALLS == {"selective_scan": 0}


def test_launcher_refuses_cpu_tensors():
    """No silent fallback: the launcher only takes CUDA tensors."""
    d, u, a, b, c = (torch.tensor(x) for x in _inputs((1, 3, 8, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        ms_kernel.selective_scan_call(d, u, a, b, c, torch.zeros(1, 8, 4))


def test_op_refuses_a_device_with_no_kernel_or_plain_version():
    """Refused on a device with neither version; on the meta device the
    op gives the plain version's shapes and dtypes."""
    with pytest.raises(ValueError, match="no kernel or plain version"):
        on_cuda("selective_scan", torch.device("xpu"))
    x = torch.ones(1, 4, 8, device="meta")
    args = (x, x, torch.ones(8, 4, device="meta"),
            torch.ones(1, 4, 4, device="meta"),
            torch.ones(1, 4, 4, device="meta"))
    got, want = ms_ops.selective_scan(*args), ms_ref.selective_scan_ref(*args)
    for g, w in zip(got, want):
        assert g.is_meta and (g.shape, g.dtype) == (w.shape, w.dtype)
    assert not on_cuda("selective_scan", torch.device("cpu"))
    assert on_cuda("selective_scan", torch.device("cuda"))


def test_registry_lists_the_scan_as_forward_only():
    reason = registry.no_reverse_reason("mamba_scan.selective_scan")
    assert reason is not None and "serving path only" in reason


def test_cuda_source_is_hand_written_and_names_the_tpu_kernel():
    src = build.source_path("mamba_scan")
    assert src.is_file() and "mamba_scan" in PACKAGES
    head = " ".join(src.read_text().split("#include")[0].split())
    assert ("src/repro/kernels/mamba_scan/mamba_scan.py _scan_kernel (:36)"
            in head.replace("// ", ""))
    assert "Bound:" in head and "Design" in head
    text = src.read_text()
    assert "cudaGetLastError()" in text and "expf(" in text
    for banned in ("cublas", "cudnn", "cub/", "thrust", "__expf",
                   "torch/"):
        assert banned not in text.lower()
    # the design: states split over a lane group whose partial sums of y
    # are reduced by warp shuffles, and a double buffer of staged chunks
    for part in ("kLaneStates", "__shfl_xor_sync(", "reduce_scatter",
                 "s_delta[2][kChunk]", "s_b[2][kChunk]", "buf ^= 1"):
        assert part in text
    py = "".join(p.read_text() for p in src.parents[1].glob("*.py"))
    assert "torch.compile" not in py


def test_nvcc_flags_of_the_scan():
    """The state update repeats the plain version's operation order: no
    contraction into FMAs, and no fast math (expf, not __expf)."""
    flags = build.nvcc_flags("mamba_scan")
    assert "--fmad=false" in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    assert not any("fast_math" in f for f in flags)
    path = build.library_path("mamba_scan")
    assert re.fullmatch(r"mamba_scan-[0-9a-f]{16}", path.parent.name)
    assert len({build.library_path(n) for n in PACKAGES}) == len(PACKAGES)


def test_jax_oracle_runs_on_the_cpu():
    """The JAX side of these tests runs on the CPU, as its own tests do."""
    assert jax.default_backend() == "cpu"
