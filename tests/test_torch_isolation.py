"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro``, and importing the port pulls
neither into the process."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_tp_serve_rank.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_has_files_to_scan():
    assert len(PORT_FILES) >= 10
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for new in ("src/repro_torch/models/transformer.py",
                "src/repro_torch/kernels/flash_attention/ops.py",
                "src/repro_torch/kernels/rmsnorm/ops.py",
                "src/repro_torch/configs/qwen3_1_7b.py",
                "src/repro_torch/launch/serve.py",
                "src/repro_torch/models/ssm.py",
                "src/repro_torch/models/moe.py",
                "src/repro_torch/models/xlstm.py",
                "src/repro_torch/kernels/mamba_scan/ops.py",
                "src/repro_torch/train/loop.py",
                "src/repro_torch/train/trainer.py",
                "src/repro_torch/train/state.py",
                "src/repro_torch/train/metrics.py",
                "src/repro_torch/optim/optimizer.py",
                "src/repro_torch/optim/compression.py",
                "src/repro_torch/checkpoint/checkpoint.py",
                "src/repro_torch/distributed/fault_tolerance.py",
                "src/repro_torch/distributed/data_parallel.py",
                "src/repro_torch/distributed/tensor_parallel.py",
                "src/repro_torch/distributed/sharding.py",
                "src/repro_torch/launch/train.py",
                "src/repro_torch/launch/steps.py",
                "src/repro_torch/launch/specs.py",
                "src/repro_torch/models/frontend.py",
                "src/repro_torch/models/attention.py",
                "src/repro_torch/models/lm.py",
                "src/repro_torch/launch/mesh.py",
                "src/repro_torch/examples/quickstart.py",
                "src/repro_torch/examples/image_recognition.py",
                "src/repro_torch/examples/time_series_latent_ode.py",
                "src/repro_torch/examples/cnf_toy.py",
                "src/repro_torch/examples/cnf_image.py",
                "src/repro_torch/examples/lm_continuous_depth.py",
                "src/repro_torch/launch/roofline.py",
                "src/repro_torch/launch/cost.py",
                "src/repro_torch/launch/dryrun.py",
                "src/repro_torch/distributed/stand_in.py",
                "src/repro_torch/analysis/__init__.py",
                "src/repro_torch/analysis/__main__.py",
                "src/repro_torch/analysis/lint.py",
                "src/repro_torch/analysis/trace_audit.py",
                "src/repro_torch/analysis/rules/common.py",
                "src/repro_torch/analysis/rules/r001_host_read.py",
                "src/repro_torch/analysis/rules/r003_launchers.py",
                "src/repro_torch/analysis/rules/r004_registry.py",
                "src/repro_torch/analysis/rules/r005_signed_buffer.py",
                "tests/torch_tp_serve_rank.py"):
        assert new in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core\n"
        "import repro_torch.kernels.alf_step.ops\n"
        "import repro_torch.kernels.registry\n"
        "import repro_torch.kernels.rmsnorm.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.mamba_scan.ops\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.train, repro_torch.optim\n"
        "import repro_torch.checkpoint, repro_torch.distributed\n"
        "import repro_torch.distributed.data_parallel\n"
        "import repro_torch.distributed.tensor_parallel\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "import repro_torch.launch.specs, repro_torch.models.frontend\n"
        "import repro_torch.launch.mesh, repro_torch.distributed.sharding\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.image_recognition\n"
        "import repro_torch.examples.time_series_latent_ode\n"
        "import repro_torch.examples.cnf_toy, repro_torch.examples.cnf_image\n"
        "import repro_torch.examples.lm_continuous_depth\n"
        "import repro_torch.launch.roofline, repro_torch.launch.cost\n"
        "import repro_torch.launch.dryrun\n"
        "import repro_torch.distributed.stand_in\n"
        "import repro_torch.analysis, repro_torch.analysis.trace_audit\n"
        "import repro_torch.analysis.rules.r004_registry\n"
        "from repro_torch.analysis.rules import r004_registry\n"
        "r004_registry._load_registries()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code],
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernel_build_module_is_not_imported_eagerly():
    """The CPU hosts that run the tests have no nvcc: importing the package
    must not import (or run) the kernel builder."""
    code = ("import sys, repro_torch.core, repro_torch.kernels.alf_step.ops\n"
            "import repro_torch.models, repro_torch.launch.serve\n"
            "import repro_torch.train, repro_torch.launch.train\n"
            "sys.exit(1 if 'repro_torch.kernels.build' in sys.modules "
            "else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
