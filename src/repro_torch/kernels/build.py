"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/*.cu`` source of a kernel package compiles with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries
land in ``build/repro_torch/<name>-<hash>/`` at the repository root, keyed
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.

Import this module only where a kernel is launched: the CPU tests import
the package on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
KERNELS_DIR = Path(__file__).resolve().parent

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Per-source additions: the ALF kernels and the selective scan's state
# update repeat their plain version's operation order bit for bit, so no
# a*b+c may be contracted there.
EXTRA_FLAGS = {"alf_step": ("--fmad=false",), "mamba_scan": ("--fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of repro_torch are built with it at first use")


def source_path(name: str) -> Path:
    """``alf_step`` -> ``kernels/alf_step/csrc/alf_step.cu``."""
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def nvcc_flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = source_path(name)
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(nvcc_flags(name)).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}" / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    ``(final path, temp path, process)`` or None when nothing to do."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", tmp,
           str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(name: str, started) -> None:
    out, tmp, proc = started
    _, err = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {source_path(name)} "
                           f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, all nvcc
    processes started together."""
    started = [(n, _start(n)) for n in names]
    errors = []
    for name, s in started:
        if s is None:
            continue
        try:
            _finish(name, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
