"""The port's odelint and trace audit (``repro_torch.analysis``) on the
CPU: the JAX package's ``tests/test_analysis.py`` fixture pairs restated
in torch idiom (known-bad caught, known-good passes, a suppression
without a reason not suppressing), R004 on the port's registries, the
port's own tree lint-clean, the value-hash contract that the JAX
retrace audit guards, and the shape audit's specs equal to the JAX
audit's for every combo."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.analysis import lint_source, run_lint
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.rules import r003_launchers, r004_registry
from repro_torch.analysis.trace_audit import (retrace_cases, shape_specs,
                                              value_hash_failures)
from repro_torch.core import (ACA, MALI, SOLVERS, Backsolve, Batching,
                              ConstantSteps, Event, GradientMethod, Naive,
                              SaveAt, Solver, solve)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def rules_of(violations):
    return sorted({v.rule for v in violations})


# --------------------------------------------------------------------------
# R001 — host reads of device values
# --------------------------------------------------------------------------

R001_BAD = """
import torch
def f(x):
    y = torch.sum(x)
    if y > 0:
        return y
    while y < 10:
        y = y * 2
    n = int(y)
    return y.item() + float(y) + n
def g(counts):
    return counts.tolist()
"""

R001_GOOD = """
import numpy as np
import torch
def f(x, grid):
    y = torch.sum(x)
    if y.dim() > 0:                 # metadata: a host value
        y = y[0]
    if isinstance(grid, torch.Tensor) and grid.shape[0] > 2:
        grid = grid[:2]
    if grid is None:               # structural
        grid = torch.zeros(3)
    if x.device.type == "cuda" and x.numel() > 4:
        pass
    host = np.diff(np.asarray([1.0, 2.0]))
    return torch.where(y > 0, y, -y), host.tolist()
def launch(fn, x):
    rc = fn()(x.data_ptr())        # a C entry's return code
    if rc != 0:
        raise RuntimeError(rc)
"""


def test_r001_bad_caught():
    vs = lint_source(R001_BAD, rules=["R001"])
    assert rules_of(vs) == ["R001"]
    msgs = " | ".join(v.message for v in vs)
    assert len(vs) == 6, msgs
    for needle in ("`if`", "`while`", "`int(...)`", "`.item()`",
                   "`float(...)`", "`.tolist()`"):
        assert needle in msgs


def test_r001_good_passes():
    assert lint_source(R001_GOOD, rules=["R001"]) == []


# --------------------------------------------------------------------------
# R003 — the CUDA launchers' contracts
# --------------------------------------------------------------------------

LAUNCHER_BAD = """
import torch
LAUNCHES = {"k": 0}
def _fn():
    return None
def k_call(x):
    out = torch.empty_like(x)
    rc = _fn()(x.data_ptr(), out.data_ptr())
    return out
"""

LAUNCHER_GOOD = """
import torch
LAUNCHES = {"k": 0}
_DTYPE_CODE = {torch.float32: 0}
def _fn():
    return None
def _check(x):
    if not x.is_cuda:
        raise ValueError("x must be a CUDA tensor")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(x.dtype)
def _launch(x, out):
    rc = _fn()(x.data_ptr(), out.data_ptr())
    if rc != 0:
        raise RuntimeError(rc)
    LAUNCHES["k"] += 1
def k_call(x):
    _check(x)
    out = torch.empty_like(x)
    _launch(x, out)
    return out
"""

CU_BAD = """
void launch(int64_t n, cudaStream_t s) {
  const int64_t blocks = n / kThreads;     // the tail is never written
  kern<<<unsigned(blocks), kThreads, 0, s>>>(n);
  kern<<<n / 128, 128, 0, s>>>(n);
}
"""

CU_GOOD = """
void launch(int64_t n, int sq, cudaStream_t s) {
  constexpr int per_block = kThreads / kLanes;   // a count, may floor
  const int64_t blocks = (n + per_block - 1) / per_block;
  kern<<<unsigned(blocks), kThreads, 0, s>>>(n);
  const dim3 grid((sq + Cfg<D>::kBQ - 1) / Cfg<D>::kBQ, heads, batch);
  kern2<<<grid, kThreads, 0, s>>>(n);
}
"""

OPS_SNIPPET = """
OP_CALLS = {"my_op": 0}
def my_op(x):
    OP_CALLS["my_op"] += 1
    return x
def my_op_work(x):                  # a helper, not an op
    return x
"""

OPS_WITH_KERNEL_BACKWARD = """
import torch
OP_CALLS = {"my_op": 0}
class _Op(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return launcher.fwd_call(x)
    @staticmethod
    def backward(ctx, g):
        return launcher.vjp_call(g)
def my_op(x):
    OP_CALLS["my_op"] += 1
    return _Op.apply(x)
"""

OPS_PLAIN_BACKWARD = """
import torch
OP_CALLS = {"my_op": 0}
class _Op(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return launcher.fwd_call(x)
    @staticmethod
    def backward(ctx, g):
        return g * 2                # no kernel: not a reverse rule here
def _plain_helper(x):
    return x
def my_op(x):
    OP_CALLS["my_op"] += 1
    return _plain_helper(_Op.apply(x))
"""


def _ops_ctx(allow=None):
    return {"kernel_package": "demo", "no_reverse_rule": allow or {}}


def test_r003_launcher_bad_caught():
    vs = lint_source(LAUNCHER_BAD, path="kernels/demo/demo.py",
                     rules=["R003"], ctx={"launcher_module": True})
    msgs = " | ".join(v.message for v in vs)
    assert "dtype check" in msgs and "device check" in msgs
    assert "launch count" in msgs


def test_r003_launcher_good_passes():
    assert lint_source(LAUNCHER_GOOD, path="kernels/demo/demo.py",
                       rules=["R003"], ctx={"launcher_module": True}) == []


def test_r003_floor_division_grid_caught():
    vs = r003_launchers.check_cuda_source(CU_BAD, "demo.cu")
    assert [v.line for v in vs] == [3, 5]
    assert all("floor division" in v.message for v in vs)


def test_r003_ceil_division_grid_passes():
    assert r003_launchers.check_cuda_source(CU_GOOD, "demo.cu") == []


def test_r003_cuda_suppression_needs_a_reason():
    src = CU_BAD.replace("// the tail is never written",
                         "// odelint: disable=R003 -- tail by grid-stride")
    assert [v.line for v in r003_launchers.check_cuda_source(
        src, "demo.cu")] == [5]
    bare = CU_BAD.replace("// the tail is never written",
                          "// odelint: disable=R003")
    assert "R000" in rules_of(r003_launchers.check_cuda_source(bare, "d.cu"))


def test_r003_allowlist_missing_caught():
    vs = lint_source(OPS_SNIPPET, path="kernels/demo/ops.py",
                     rules=["R003"], ctx=_ops_ctx())
    assert [v.message.split("`")[1] for v in vs] == ["my_op"]
    assert "NO_REVERSE_RULE" in vs[0].message


def test_r003_allowlist_entry_passes():
    allow = {"demo.my_op": "forward-only serving kernel; training uses "
                           "the plain PyTorch version"}
    assert lint_source(OPS_SNIPPET, path="kernels/demo/ops.py",
                       rules=["R003"], ctx=_ops_ctx(allow)) == []


def test_r003_placeholder_reason_caught():
    vs = lint_source(OPS_SNIPPET, path="kernels/demo/ops.py",
                     rules=["R003"], ctx=_ops_ctx({"demo.my_op": "todo"}))
    assert any("placeholder" in v.message for v in vs)


def test_r003_function_with_kernel_backward_passes():
    assert lint_source(OPS_WITH_KERNEL_BACKWARD, path="kernels/demo/ops.py",
                       rules=["R003"], ctx=_ops_ctx()) == []


def test_r003_function_without_kernel_backward_caught():
    vs = lint_source(OPS_PLAIN_BACKWARD, path="kernels/demo/ops.py",
                     rules=["R003"], ctx=_ops_ctx())
    assert any("my_op" in v.message and "NO_REVERSE_RULE" in v.message
               for v in vs)


# --------------------------------------------------------------------------
# R004 — registry completeness, on the port's registries
# --------------------------------------------------------------------------

def test_r004_missing_member_caught():
    class Incomplete(GradientMethod):
        name = "incomplete"

    missing = r004_registry.missing_interface(Incomplete, GradientMethod)
    assert "integrate" in missing and "default_solver" in missing


def test_r004_complete_subclasses_pass():
    for cls in (MALI, Naive, ACA, Backsolve):
        assert r004_registry.missing_interface(cls, GradientMethod) == []
    for inst in SOLVERS.values():
        assert r004_registry.missing_interface(type(inst), Solver) == []
    for sub in Batching.__subclasses__():
        assert r004_registry.missing_interface(sub, Batching) == []


def test_r004_reads_the_ports_registries(tmp_path):
    regs = dict((base.__name__, reg)
                for base, reg in r004_registry._load_registries())
    assert set(regs) == {"Solver", "GradientMethod", "Batching",
                         "AdmissionPolicy", "SchedulingPolicy",
                         "CachePolicy", "TrainLoop", "MetricsEmitter",
                         "TraceEstimator"}
    for reg in regs.values():
        for cls in reg:
            assert cls.__module__.startswith("repro_torch.")
    # with no port test to mention them, every registered class is caught
    vs = r004_registry.check_registries(tmp_path)
    assert len(vs) == sum(len(r) for r in regs.values())
    assert r004_registry.check_registries(REPO_ROOT / "tests") == []


REGISTERED_SOLVER_NAMES = ["alf", "bosh3", "dopri5", "euler", "heun2",
                           "heun_euler", "midpoint", "rk2", "rk23", "rk4"]


def test_solver_name_list_matches_registry():
    assert REGISTERED_SOLVER_NAMES == sorted(SOLVERS)


@pytest.mark.parametrize("name", REGISTERED_SOLVER_NAMES)
def test_every_registered_solver_solves(name):
    def f(params, z, t):
        return -params * z

    sol = solve(f, torch.tensor(0.7), torch.ones(2), 0.0, 1.0, solver=name,
                controller=ConstantSteps(2), gradient=Naive())
    assert sol.ys.shape == (2,)
    np.testing.assert_allclose(sol.ys.numpy(), np.exp(-0.7) * np.ones(2),
                               rtol=0.2)


# --------------------------------------------------------------------------
# R005 — signed-buffer discipline
# --------------------------------------------------------------------------

R005_BAD = """
import torch
def _replay_bwd(res, ct):
    ts, hs = res
    h = torch.abs(hs[0])           # strips the recorded step's sign
    return h * ct + hs[1].abs()
"""

R005_GOOD = """
import torch
def forward_driver(t, h, t1):
    # abs is fine on the FORWARD side (direction-agnostic span checks)
    return torch.where(torch.abs(h) >= torch.abs(t1 - t), t1 - t, h)
def _replay_bwd(res, ct):
    ts, hs = res
    return -hs[0] * ct             # signed replay
"""


def test_r005_bad_caught():
    vs = lint_source(R005_BAD, rules=["R005"])
    assert len(vs) == 2 and rules_of(vs) == ["R005"]


def test_r005_good_passes():
    assert lint_source(R005_GOOD, rules=["R005"]) == []


# --------------------------------------------------------------------------
# Suppressions
# --------------------------------------------------------------------------

def test_suppression_with_reason_suppresses():
    src = R001_BAD.replace("if y > 0:",
                           "if y > 0:  # odelint: disable=R001 -- demo")
    vs = lint_source(src, rules=["R001"])
    assert len(vs) == 5 and all(v.line != 5 for v in vs)


def test_suppression_without_reason_is_flagged():
    src = R001_BAD.replace("if y > 0:",
                           "if y > 0:  # odelint: disable=R001")
    vs = lint_source(src, rules=["R001"])
    assert any(v.rule == "R000" for v in vs)       # bare disable reported
    assert any(v.rule == "R001" and v.line == 5 for v in vs)  # not suppressed


# --------------------------------------------------------------------------
# The port's tree stays clean; the CLI
# --------------------------------------------------------------------------

def test_port_is_lint_clean():
    assert run_lint(REPO_ROOT) == []


def test_cli_lint_only(tmp_path, capsys):
    report = tmp_path / "report.json"
    assert analysis_main(["--repo", str(REPO_ROOT), "--skip-audit",
                          "--json", str(report)]) == 0
    import json
    got = json.loads(report.read_text())
    assert got["ok"] and got["lint"]["count"] == 0
    assert "analysis: OK" in capsys.readouterr().out


def test_cli_with_the_audit_on_the_cpu(tmp_path):
    report = tmp_path / "report.json"
    assert analysis_main(["--repo", str(REPO_ROOT), "--device", "cpu",
                          "--json", str(report)]) == 0
    import json
    audit = json.loads(report.read_text())["trace_audit"]
    assert audit["ok"] and audit["combos"] >= 48 + 12 + 3
    assert audit["shape_failures"] == [] == audit["retrace_failures"]
    assert all(audit["retrace_counts"].values())
    assert "no counterpart" in audit["retrace"]


# --------------------------------------------------------------------------
# The value-hash contract (what the JAX retrace audit guards)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,fresh", retrace_cases(),
                         ids=[c[0] for c in retrace_cases()])
def test_fresh_statics_compare_and_hash_equal(name, fresh):
    assert value_hash_failures(name, fresh) == []


def test_identity_hashed_static_is_caught():
    # negative control: a fresh lambda per Event has a new identity
    def fresh_bad():
        return dict(event=Event(lambda z, t: torch.sum(z) - 10.0))

    assert len(value_hash_failures("bad", fresh_bad)) == 1


def test_saveat_value_semantics():
    a = SaveAt(ts=np.linspace(0.0, 1.0, 5))
    b = SaveAt(ts=np.linspace(0.0, 1.0, 5))
    c = SaveAt(ts=np.linspace(0.0, 2.0, 5))
    assert a == b and hash(a) == hash(b)
    assert a != c
    assert SaveAt(ts=torch.linspace(0, 1, 5)) == SaveAt(
        ts=torch.linspace(0, 1, 5))
    assert SaveAt() == SaveAt() and hash(SaveAt()) == hash(SaveAt())
    assert SaveAt(steps=True) != SaveAt()


def test_event_value_semantics():
    def cond(z, t):
        return z[0]

    assert Event(cond) == Event(cond)
    assert hash(Event(cond)) == hash(Event(cond))
    assert Event(cond, direction=+1) != Event(cond)


# --------------------------------------------------------------------------
# The shape audit's specs against the JAX audit's, combo by combo
# --------------------------------------------------------------------------

def _jax_shape_specs():
    """Every JAX audit combo's output specs, through jax.eval_shape, as
    the JAX package's run_shape_audit builds them."""
    from repro.analysis import trace_audit as jta
    from repro.core import (ACA, ALF, MALI, AdaptiveController, Backsolve,
                            ConstantSteps, Dopri5, HeunEuler, Lockstep,
                            Naive, PerSample, SaveAt, solve)
    f, p_spec = jta._dynamics(), jta._param_specs()
    D, B, T = jta.D, jta.B, jta.T
    out = {}

    def spec(a):
        return tuple(a.shape), str(a.dtype)

    for pname, gradient, solver in jta._method_solver_pairs():
        for cname, controller in jta._controllers():
            for dname, (t0, t1) in (("fwd", (0.0, 1.0)),
                                    ("rev", (1.0, 0.0))):
                batchings = [("unbatched", None), ("lockstep", Lockstep())]
                if controller.adaptive:
                    batchings.append(("per_sample", PerSample()))
                for bname, batching in batchings:
                    z = jax.ShapeDtypeStruct((B, D) if batching else (D,),
                                             jnp.float32)
                    ts = jnp.linspace(t0, t1, T).astype(jnp.float32)
                    sol = jax.eval_shape(
                        lambda z0, p: solve(f, p, z0, t0, t1, solver=solver,
                                            controller=controller,
                                            gradient=gradient,
                                            saveat=SaveAt(ts=ts),
                                            batching=batching), z, p_spec)
                    out[f"{pname}/{cname}/{dname}/{bname}"] = {
                        "ys": spec(sol.ys), "ts": spec(sol.ts),
                        **{c: spec(getattr(sol.stats, c)) for c in
                           ("n_accepted", "n_rejected", "n_fevals")}}
    grad_cases = [
        ("grad/mali/alf", MALI(), ALF(), ConstantSteps(4)),
        ("grad/mali/alf-pallas", MALI(), ALF(backend="pallas"),
         ConstantSteps(4)),
        ("grad/naive/alf", Naive(), ALF(), AdaptiveController(1e-2, 1e-3, 8)),
        ("grad/naive/alf-pallas", Naive(), ALF(backend="pallas"),
         AdaptiveController(1e-2, 1e-3, 8)),
        ("grad/aca/heun_euler", ACA(), HeunEuler(),
         AdaptiveController(1e-2, 1e-3, 8)),
        ("grad/backsolve/dopri5", Backsolve(), Dopri5(), ConstantSteps(4)),
    ]
    for name, gradient, solver, controller in grad_cases:
        for dname, (t0, t1) in (("fwd", (0.0, 1.0)), ("rev", (1.0, 0.0))):
            ts = jnp.linspace(t0, t1, T).astype(jnp.float32)

            def loss(p, z0):
                return jnp.sum(solve(f, p, z0, t0, t1, solver=solver,
                                     controller=controller,
                                     gradient=gradient,
                                     saveat=SaveAt(ts=ts)).ys)
            g = jax.eval_shape(jax.grad(loss), p_spec,
                               jax.ShapeDtypeStruct((D,), jnp.float32))
            out[f"{name}/{dname}"] = {f"grad[{k}]": spec(v)
                                      for k, v in g.items()}
    return out


def test_shape_audit_specs_equal_the_jax_audits():
    port = shape_specs("cpu")
    want = _jax_shape_specs()
    assert sorted(port) == sorted(want)
    assert len(port) >= 48 + 12
    for combo, specs in want.items():
        assert port[combo] == specs, combo
