"""Where a rank's device memory goes in FSDP training (not collected; needs
an H100).

    python tests/torch_fsdp_memory_probe.py [OUT]

Runs ``chip_smoke.py``'s phase 22 (a) (granite-20b at 2 of 52 layers,
bf16, four gloo ranks sharing the card on a (data 2, model 2) mesh, its
checks included) with each rank's allocator read at every FSDP event:
before and after each gather of a leaf over 'data' (forward), each
re-gather for a backward, and each reduce-scatter of a gradient, the
peak between two events beside it; and, for each tensor that autograd
saves inside a layer's ``fsdp_gathered`` block, whether the pack hook
kept it as its shard or raw (raw ones counted by shape and dtype).
The events reset the allocator's peak, so the step marks' peaks cover
only the time since the last event.
Writes ``OUT/events_rank<r>.json`` and ``OUT/saved_rank<r>.json``
(default ``build/fsdp_probe``) and prints each rank's step marks.
Imports no JAX.
"""
import atexit
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def _instrument(rank: int, out: Path) -> None:
    """Wrap this rank's FSDP gathers, re-gathers and reduce-scatters and
    the saved-tensor hooks to log the allocator."""
    import torch
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.distributed import data_parallel as dp
    events, raw, packed = [], {}, [0]

    def mark(name, shape):
        events.append((name, list(shape), torch.cuda.memory_allocated(),
                       torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()

    fwd, bwd, regather = (dp._GatherData.forward, dp._GatherData.backward,
                          dp._Fsdp.regather)

    def forward(ctx, shard, fsdp, dim):
        mark("pre_gather", shard.shape)
        whole = fwd(ctx, shard, fsdp, dim)
        mark("gathered", whole.shape)
        return whole

    def backward(ctx, g):
        mark("pre_reduce_scatter", g.shape)
        grads = bwd(ctx, g)
        mark("reduce_scattered", grads[0].shape)
        return grads

    def regather_(self, shard, dim):
        n = dp.FSDP_GATHERS["backward"]
        mark("pre_regather", shard.shape)
        whole = regather(self, shard, dim)
        if dp.FSDP_GATHERS["backward"] != n:
            mark("regathered", whole.shape)
        return whole

    hooks = torch.autograd.graph.saved_tensors_hooks

    class Logged(hooks):
        def __init__(self, pack, unpack):
            def pack_(t):
                kept = pack(t)
                if kept is t:
                    c = raw.setdefault(f"{tuple(t.shape)} {t.dtype}", [0, 0])
                    c[0] += 1
                    c[1] += t.untyped_storage().nbytes()
                else:
                    packed[0] += 1
                return kept
            super().__init__(pack_, unpack)

    dp._GatherData.forward = staticmethod(forward)
    dp._GatherData.backward = staticmethod(backward)
    dp._Fsdp.regather = regather_
    torch.autograd.graph.saved_tensors_hooks = Logged

    def write():
        (out / f"events_rank{rank}.json").write_text(json.dumps(events))
        (out / f"saved_rank{rank}.json").write_text(json.dumps(
            {"raw_by_shape": raw, "packed": packed[0]}))

    atexit.register(write)


def main(argv) -> int:
    if argv[1:2] == ["--tp-rank"]:
        # chip_smoke.py --tp-rank PART RANK WORLD DIR, plus OUT
        out = Path(argv[-1])
        _instrument(int(argv[3]), out)
        return cs._tp_rank(argv[2:-1])
    import torch
    out = Path(argv[1]) if len(argv) > 1 else ROOT / "build" / "fsdp_probe"
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(cs.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import PACKAGES, build
    build.build(PACKAGES)
    # the ranks run this file, which instruments them first
    spawn = cs._tp_spawn

    def spawn_here(part, d, world):
        import subprocess
        popen = subprocess.Popen

        def probe_popen(cmd, **kw):
            i = cmd.index("--tp-rank")
            return popen([cmd[0], str(Path(__file__).resolve()),
                          *cmd[i:], str(out)], **kw)

        subprocess.Popen = probe_popen
        try:
            return spawn(part, d, world)
        finally:
            subprocess.Popen = popen

    cs._tp_spawn = spawn_here
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        res = cs._tp_granite(Path(tmp))
    for r, got in enumerate(res["ranks"]):
        print("rank", r, got["coord"], json.dumps(got["memory"]),
              json.dumps(got["memory_terms"]))
    print("one rank", json.dumps(res["one_rank"]["memory"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
