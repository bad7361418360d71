"""Hold this checkout's ALF library against another build of
``alf_step.cu`` on the card: the seven vector kernels (``alf_midpoint``,
``alf_update``, ``alf_midpoint_vjp``, ``alf_bwd_pre``, ``alf_bwd_post``,
``alf_update_vjp``, ``alf_inverse``) bit for bit, and their times in
turns. A base library that runs some of them as other kernels (an older
commit's scalar loops, say) is held to the same bits through the same C
entries.

    git show <commit>:src/repro_torch/kernels/alf_step/csrc/alf_step.cu \\
        > build/ab/base_alf_step.cu
    python tools/alf_ab.py --base build/ab/base_alf_step.cu [--turns 2] \\
        [--base-tree DIR] [--out build/alf_ab.jsonl]

Both libraries are built with this checkout's nvcc flags for
``alf_step`` (``--fmad=false`` included): ``base`` from ``--base`` and
``new`` from this checkout, one nvcc at a time, twice each in turns
(base, new, new, base). It prints one JSON line a phase (and writes them
to ``--out``):

- ``build``: each library's nvcc seconds, build by build, and its
  count of kernels (the functions ``cuobjdump -sass`` lists);
- ``info``: registers and local bytes a thread and resident blocks per
  SM of the new library's seven vector kernels (``alf_vec_kernel_info``:
  ``cudaFuncGetAttributes`` and the occupancy API);
- ``bits``: every kernel of ``base`` and ``new`` on the same inputs:
  ``chip_smoke.py``'s offset cases (every input at 16-byte offsets 0-3,
  one at a time and all together; the outputs fresh and at offsets 1-3;
  f32, bf16 and f64; n = 1, TAIL_N, the main path's 2048 x 64 and
  2^20 + 37; a per-row h at 3 x 37, 2048 x 64, 8192 x 37 and the
  CNF's 1024 x 1570), and 2^24 and 2^25 elements; the midpoint and its
  VJP at sign +1 and -1, the update and ``alf_bwd_pre`` at eta 0.9,
  ``alf_bwd_post``, ``alf_update_vjp`` and ``alf_inverse`` at eta 1.0
  and 0.9; every output must be bit-equal;
- ``times``: every kernel of both libraries at ``--sizes`` (f32; the
  main path's 2048 x 64, Backsolve's and the CNF's packed states, 2^24
  and 2^25 by default), ``alf_bwd_post`` and ``alf_inverse`` at eta 0.9
  and 1.0, through the C entry: CUDA-event ms a call (eager) and ms a
  call inside a CUDA graph, in turns (base, new, new, base; ``--turns``
  times), beside the bound of the work the op declares;
- ``ceiling``: one PyTorch copy (``copy_``: 1 read, 1 write) and one
  add (``torch.add(out=)``: 2 reads, 1 write) at 2^24 and 2^25 f32, their
  ms and share of their byte bound: what a plain stream reaches on this
  card.

With ``--base-tree DIR`` it first times the build of every kernel
source of DIR and of this checkout (``build_all``), one after the
other. It fails (exit 1) if a build fails or an output differs; it
needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.alf_step import alf_step  # noqa: E402
from repro_torch.kernels.alf_step.ops import alf_work  # noqa: E402
from repro_torch.launch.roofline import card_rates  # noqa: E402

SLICE_N = 2048 * 64
TAIL_N = 1500 * 128 + 37
# above one resident wave of threads on an H100 (132 x 2048): vectors
WAVE_N = (1 << 20) + 37
BIG = (1 << 24, 1 << 25)
# name: (inputs, outputs, params checked bit for bit, params timed)
VEC = {"alf_midpoint": (2, 1, (1.0, -1.0), (-1.0,)),
       "alf_update": (3, 2, (0.9,), (0.9,)),
       "alf_midpoint_vjp": (1, 1, (1.0, -1.0), (-1.0,)),
       "alf_bwd_pre": (4, 2, (0.9,), (0.9,)),
       "alf_bwd_post": (6, 4, (1.0, 0.9), (0.9, 1.0)),
       "alf_update_vjp": (2, 2, (0.9, 1.0), (0.9,)),
       "alf_inverse": (3, 2, (1.0, 0.9), (0.9, 1.0))}
INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float64: torch.int64}
SIZES = (SLICE_N, 270464, 1607680, *BIG)


def emit(out, obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    out.write(line + "\n")


def _build_both(base: Path):
    """{"base": (library, [nvcc seconds], kernels), "new": ...}: each
    source built alone, in turns (base, new, new, base), so that no build
    shares the host's cores with another; kernels is the number of
    functions ``cuobjdump -sass`` lists in the library."""
    flags = build.nvcc_flags("alf_step")
    nvcc = build.nvcc_path()
    srcs = {"base": base, "new": build.source_path("alf_step")}
    libs = {k: ROOT / "build" / "ab" / k / "libalf_step.so" for k in srcs}
    seconds = {k: [] for k in srcs}
    for label in ("base", "new", "new", "base"):
        libs[label].parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *flags, "-o", str(libs[label]),
                              str(srcs[label])], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{res.stderr}")
        seconds[label].append(time.perf_counter() - t0)
    cuobjdump = Path(nvcc).resolve().parent / "cuobjdump"
    out = {}
    for label, lib in libs.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        out[label] = (lib, seconds[label], sass.count("Function :"))
    return out


def _build_trees(base_tree: Path) -> dict:
    """Seconds to build every kernel source of ``base_tree`` and of this
    checkout, one after the other, each from nothing (into a fresh
    directory) in a process of its own."""
    code = ("import json, sys, tempfile, time; from pathlib import Path; "
            "sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import PACKAGES, build; "
            "build.BUILD_DIR = Path(tempfile.mkdtemp()); "
            "t = time.perf_counter(); build.build(PACKAGES); "
            "print(json.dumps({'build_s': time.perf_counter() - t}))")
    out = {}
    for label, tree in (("base", base_tree), ("new", ROOT)):
        res = subprocess.run([sys.executable, "-c", code,
                              str(Path(tree).resolve() / "src")],
                             capture_output=True, text=True, check=True)
        out[label] = json.loads(res.stdout.strip().splitlines()[-1])
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in VEC:
        fn = getattr(lib, name)
        fn.argtypes = alf_step._ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib


def _call(lib, name, ins, h, row, param, outs) -> None:
    rc = getattr(lib, name)(
        alf_step._DTYPE_CODE[ins[0].dtype], ins[0].numel(),
        *[x.data_ptr() for x in ins], h.data_ptr(), row, param,
        *[y.data_ptr() for y in outs],
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _offset_cases(gen, n_in, dtype):
    """chip_smoke.py's offset cases of one dtype: (n, h, row, input
    offsets)."""
    h = torch.tensor(0.23, device="cuda").to(
        torch.promote_types(dtype, torch.float32))
    patterns = [(0,) * n_in]
    for off in (1, 2, 3):
        patterns += [tuple(off if i == j else 0 for i in range(n_in))
                     for j in range(n_in)]
        if n_in > 1:
            patterns.append((off,) * n_in)
    cases = [(n, h, 0) for n in (1, TAIL_N, SLICE_N, WAVE_N)]
    for b, d in ((3, 37), (2048, 64), (8192, 37), (1024, 1570)):
        rows = (torch.rand(b, device="cuda", generator=gen) - 0.5) * 0.8
        cases.append((b * d, rows.to(h.dtype), d))
    for n, hh, row in cases:
        for offs in patterns:
            yield n, hh, row, offs


def _bits(base, new, gen) -> dict:
    """Every output of base and new bit-equal on the same inputs."""
    checks = {name: 0 for name in VEC}
    for name, (n_in, n_out, params, _) in VEC.items():
        for dtype in INT_VIEW:
            cases = list(_offset_cases(gen, n_in, dtype))
            hd = cases[0][1]
            cases += [(n, hd, 0, (0,) * n_in) for n in BIG]
            for n, hh, row, offs in cases:
                ins = [torch.randn(n + 3, device="cuda", generator=gen)
                       .to(dtype)[o:o + n] for o in offs]
                out_offs = (None,) if n in BIG else (None, 1, 2, 3)
                for out_off in out_offs:
                    for p in params:
                        got = []
                        for lib in (base, new):
                            if out_off is None:
                                outs = [torch.empty(n, device="cuda",
                                                    dtype=dtype)
                                        for _ in range(n_out)]
                            else:
                                outs = [torch.empty(
                                    n + 3, device="cuda", dtype=dtype)
                                    [out_off:out_off + n]
                                    for _ in range(n_out)]
                            _call(lib, name, ins, hh, row, p, outs)
                            got.append(outs)
                        torch.cuda.synchronize()
                        for a, b in zip(*got):
                            if not torch.equal(a.view(INT_VIEW[dtype]),
                                               b.view(INT_VIEW[dtype])):
                                raise RuntimeError(
                                    f"{name} {dtype} n={n} row {row} input "
                                    f"offsets {offs} output offset "
                                    f"{out_off} param {p}: base and new "
                                    "differ")
                        checks[name] += 1
                del ins
            torch.cuda.empty_cache()
    return checks


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _times(libs: dict, gen, card: str, sizes, turns: int):
    bw, peak, _ = card_rates(card)
    labels = list(libs)
    order = ["base", "new", "new", "base"] * turns
    rows = []
    h = torch.tensor(0.23, device="cuda")
    for n in sizes:
        reps = max(20, min(500, int(2e8 // n)))
        bufs = [torch.randn(n, device="cuda", generator=gen)
                for _ in range(10)]
        for name, (n_in, n_out, _, params) in VEC.items():
            ins, outs = bufs[:n_in], bufs[6:6 + n_out]
            for p in params:
                ms = {k: [] for k in labels}
                graph = {k: [] for k in labels}
                for label in order:
                    def fn(lib=libs[label]):
                        _call(lib, name, ins, h, 0, p, outs)
                    ms[label].append(_time_ms(fn, reps))
                    graph[label].append(_graph_ms(fn, min(reps, 100)))
                bound, by = _bound(alf_work(name, bufs[0], h), bw, peak)
                row = {"name": name, "n": n, "param": p, "bound_ms": bound,
                       "bound_by": by}
                for k in labels:
                    row[k] = {"ms": sum(ms[k]) / len(ms[k]),
                              "ms_runs": ms[k],
                              "graph_ms": sum(graph[k]) / len(graph[k]),
                              "graph_runs": graph[k]}
                    row[k]["share_of_bound"] = bound / row[k]["ms"]
                rows.append(row)
        del bufs
        torch.cuda.empty_cache()
    return rows


def _ceiling(gen, card: str, turns: int):
    """A PyTorch copy and add at 2^24 and 2^25 f32: ms and share of
    their byte bound."""
    bw = card_rates(card)[0]
    rows = []
    for n in BIG:
        a, b, c = (torch.randn(n, device="cuda", generator=gen)
                   for _ in range(3))
        for what, fn, moved in (
                ("copy_", lambda: c.copy_(a), 2),
                ("add", lambda: torch.add(a, b, out=c), 3)):
            ms = [_time_ms(fn, 20) for _ in range(2 * turns)]
            bound = moved * 4 * n / bw * 1e3
            rows.append({"op": what, "n": n, "ms": sum(ms) / len(ms),
                         "ms_runs": ms, "bound_ms": bound,
                         "share_of_bound": bound / (sum(ms) / len(ms))})
        del a, b, c
        torch.cuda.empty_cache()
    return rows


def _bound(work, bw: float, peak: float):
    bytes_ms, ops_ms = work.bytes / bw * 1e3, work.flops / peak * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True,
                    help="the alf_step.cu to hold this checkout's against")
    ap.add_argument("--base-tree", type=Path,
                    help="a checkout whose kernel build (all sources) is "
                         "timed beside this one's (phase build_all)")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "alf_ab.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("alf_ab: no CUDA device", file=sys.stderr)
        return 2
    sizes = [int(x) for x in args.sizes.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    card = torch.cuda.get_device_name(0)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as out:
        if args.base_tree is not None:
            emit(out, {"phase": "build_all", "nvidia_smi": smi,
                       **_build_trees(args.base_tree)})
        built = _build_both(args.base)
        emit(out, {"phase": "build", "card": card, "nvidia_smi": smi,
                   "nvcc_s": {k: s for k, (_, s, _) in built.items()},
                   "kernels": {k: c for k, (_, _, c) in built.items()}})
        libs = {k: _load(p) for k, (p, _, _) in built.items()}
        emit(out, {"phase": "info", "new": {
            name: alf_step.vec_kernel_info(name, torch.float32, libs["new"])
            for name in alf_step.VEC_KERNELS}})
        gen = torch.Generator(device="cuda").manual_seed(31)
        checks = _bits(libs["base"], libs["new"], gen)
        emit(out, {"phase": "bits", "bit_equal": True, "checks": checks})
        for row in _times(libs, gen, card, sizes, args.turns):
            emit(out, {"phase": "times", "nvidia_smi": smi, **row})
        emit(out, {"phase": "ceiling", "nvidia_smi": smi,
                   "rows": _ceiling(gen, card, args.turns)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
