"""The port's checkpoints share the JAX package's on-disk layout: a tree
saved by either package restores bit for bit in the other (bf16 leaves
included, stored as uint16), through dict keys, list indices, NamedTuple
fields and ``None`` nodes. Also the port's atomic ``.tmp`` rename,
``AsyncCheckpointer`` with keep-k, ``run_with_recovery`` and
``SyntheticStream``.
"""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import SyntheticStream as JaxStream
from repro.distributed import fault_tolerance as jft
from repro_torch import tree_util
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig, SyntheticStream, make_batch
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.optim.optimizer import OptState


class Pair(NamedTuple):
    first: object
    second: object


def _np_tree(seed=0):
    """A tree of every node kind, float32 / bf16-representable / int32."""
    rng = np.random.default_rng(seed)
    return {
        "b": [rng.standard_normal((3, 2)).astype(np.float32),
              rng.integers(-5, 5, (4,)).astype(np.int32)],
        "a": {"bf": rng.standard_normal((2, 5)).astype(np.float32),
              "none": None},
        "opt": Pair(rng.standard_normal((6,)).astype(np.float32),
                    {"z": rng.standard_normal((1, 1)).astype(np.float32)}),
        "scalar": np.int32(7),
    }


def _jax_tree(np_tree):
    def leaf(path, a):
        dt = jnp.bfloat16 if "bf" in jax.tree_util.keystr(path) else None
        return jnp.asarray(a, dtype=dt)
    return jax.tree_util.tree_map_with_path(leaf, np_tree)


def _torch_tree(np_tree):
    def conv(node, key=""):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, Pair):
            return Pair(conv(node.first), conv(node.second))
        if isinstance(node, list):
            return [conv(v) for v in node]
        t = torch.as_tensor(np.asarray(node))
        return t.to(torch.bfloat16) if key == "bf" else t
    return conv(np_tree)


def _as_np(leaf):
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bf16"
        return leaf.numpy(), str(leaf.dtype).split(".")[-1]
    a = np.asarray(leaf)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16), "bf16"
    return a, str(a.dtype)


def _assert_bit_equal(port_tree, jax_tree):
    port = dict(tckpt._leaves_with_paths(port_tree))
    want = {"/".join(jckpt._path_str(p) for p in path): leaf for path, leaf
            in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    assert sorted(port) == sorted(want)
    for key in want:
        (a, adt), (b, bdt) = _as_np(port[key]), _as_np(want[key])
        assert adt == bdt, (key, adt, bdt)
        assert a.shape == b.shape and np.array_equal(a, b), key


def test_jax_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    np_tree = _np_tree(0)
    jt = _jax_tree(np_tree)
    path = jckpt.save_checkpoint(str(tmp_path), 12, jt,
                                 metadata={"k": "v"})
    like = tree_util.tree_map(torch.zeros_like, _torch_tree(_np_tree(1)))
    got, meta = tckpt.restore_checkpoint(path, like)
    assert meta == {"k": "v"}
    assert isinstance(got["opt"], Pair) and got["a"]["none"] is None
    assert got["a"]["bf"].dtype == torch.bfloat16
    _assert_bit_equal(got, jt)
    step, got2, _ = tckpt.restore_latest(str(tmp_path), like)
    assert step == 12
    _assert_bit_equal(got2, jt)


def test_port_checkpoint_restores_bit_equal_in_jax(tmp_path):
    np_tree = _np_tree(2)
    tt = _torch_tree(np_tree)
    path = tckpt.save_checkpoint(str(tmp_path), 3, tt, metadata={"x": 1})
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3 and manifest["metadata"] == {"x": 1}
    like = jax.tree_util.tree_map(jnp.zeros_like, _jax_tree(_np_tree(3)))
    got, meta = jckpt.restore_checkpoint(path, like)
    assert meta == {"x": 1}
    _assert_bit_equal(tt, got)
    assert sorted(manifest["keys"]) == manifest["keys"]
    assert jckpt.list_checkpoints(str(tmp_path)) == [(3, path)]


def test_opt_state_paths_are_the_jax_packages():
    """A NamedTuple's leaves are keyed by field name, as in JAX."""
    st = OptState(torch.zeros((), dtype=torch.int32), {"w": torch.ones(2)},
                  {"w": torch.ones(2)}, {"w": torch.ones(2)})
    keys = [k for k, _ in tckpt._leaves_with_paths({"opt": st})]
    assert keys == ["opt/step", "opt/m/w", "opt/v/w", "opt/master/w"]


def test_restore_refuses_a_shape_mismatch(tmp_path):
    path = tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(path, {"w": torch.ones(4)})


def test_save_is_atomic_and_overwrites(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000005.tmp"))   # a crashed write
    tckpt.save_checkpoint(d, 5, {"w": torch.ones(2)})
    tckpt.save_checkpoint(d, 5, {"w": torch.full((2,), 2.0)})
    assert [s for s, _ in tckpt.list_checkpoints(d)] == [5]
    assert not os.path.exists(os.path.join(d, "step_00000005.tmp"))
    got, _ = tckpt.restore_checkpoint(os.path.join(d, "step_00000005"),
                                      {"w": torch.zeros(2)})
    assert torch.equal(got["w"], torch.full((2,), 2.0))


def test_async_checkpointer_keeps_the_newest(tmp_path):
    d = str(tmp_path / "ck")
    ck = tckpt.AsyncCheckpointer(d, keep=2)
    w = torch.arange(4.0)
    for step in (1, 2, 3, 4):
        ck.save(step, {"w": w * step}, metadata={"step": step})
    w.mul_(100)                          # the snapshot was taken at save()
    ck.wait()
    assert [s for s, _ in tckpt.list_checkpoints(d)] == [3, 4]
    step, got, meta = tckpt.restore_latest(d, {"w": torch.zeros(4)})
    assert step == 4 and meta == {"step": 4}
    assert torch.equal(got["w"], torch.arange(4.0) * 4)
    ck.close()
    assert tckpt.restore_latest(str(tmp_path / "empty"), {}) is None


def test_run_with_recovery_matches_jax():
    """Retries RuntimeError/OSError/ValueError up to max_failures with a
    restore before each attempt; other exceptions pass straight through."""
    def outcome(ft, fail_times, exc=RuntimeError):
        calls = []

        def loop(resume):
            calls.append(resume)
            if len(calls) <= fail_times:
                raise exc("boom")
            return 9

        try:
            final, st = ft.run_with_recovery(loop, lambda: 4, max_failures=2)
            return final, st.failures, st.restores, calls
        except Exception as e:            # noqa: BLE001 — compared below
            return type(e).__name__, len(calls)

    for fails in (0, 2, 3):
        assert outcome(tft, fails) == outcome(jft, fails)
    assert outcome(tft, 1, KeyError) == outcome(jft, 1, KeyError)
    assert outcome(tft, 1, KeyError) == ("KeyError", 1)


def test_synthetic_stream_matches_jax():
    cfg = smoke_config("qwen3-1.7b")
    dcfg = dict(seed=3, global_batch=4, seq_len=8)
    port = SyntheticStream(cfg, DataConfig(**dcfg), device="cpu",
                           start_step=2)
    jax_stream = JaxStream(cfg, JaxDataConfig(**dcfg), start_step=2)
    for _ in range(3):
        a, b = next(port), next(jax_stream)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].device.type == "cpu"
            assert np.array_equal(a[k].numpy(), np.asarray(b[k]))
    assert port.step == 5
    assert np.array_equal(
        next(iter(SyntheticStream(cfg, DataConfig(**dcfg), device="cpu",
                                  start_step=5)))["tokens"].numpy(),
        make_batch(cfg, DataConfig(**dcfg), 5)["tokens"])
