"""Checkpointing: flat npz + json manifest, atomic, async, keep-k.

The port of the JAX package's ``repro.checkpoint``, with its on-disk
layout exactly, so either package restores the other's checkpoints:

    <dir>/step_<N:08d>/arrays.npz + manifest.json

written into a ``.tmp`` staging directory and renamed into place, so a
crash mid-write never corrupts the latest checkpoint. Each leaf is stored
under its key path, the ``"/"``-joined dict keys, list and tuple indices
and NamedTuple field names from the root (``None`` nodes hold no leaf);
paths, not flattening order, identify leaves, so torch's insertion-order
dict flattening and JAX's sorted order meet on disk. bfloat16 leaves,
which npz cannot represent, are stored bit-exactly as uint16 and viewed
back as bfloat16 when the restore template says so.

:class:`AsyncCheckpointer` copies the tensors to the host on the caller's
thread (a snapshot the next steps cannot change) and writes them on a
background thread, keeping the newest ``keep``. ``restore_latest`` is the
fault-tolerance entry point (``distributed.fault_tolerance``).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Iterator[Tuple[str, Any]]:
    """(path entry, child) pairs of one tree node, as the JAX package
    names them: dict keys (sorted), NamedTuple fields, list/tuple
    indices."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield str(k), node[k]
    elif _is_namedtuple(node):
        for name in node._fields:
            yield name, getattr(node, name)
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            yield str(i), child


def _leaves_with_paths(tree: Pytree, prefix: Tuple[str, ...] = ()
                       ) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        for name, child in _children(tree):
            yield from _leaves_with_paths(child, prefix + (name,))
        return
    yield _SEP.join(prefix), tree


def _to_savable(t) -> np.ndarray:
    """A leaf as host numpy; bfloat16 bit-exactly as uint16."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_savable(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype on its device."""
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device)


def _flatten_with_paths(tree: Pytree) -> Dict[str, np.ndarray]:
    return {key: _to_savable(leaf) for key, leaf in _leaves_with_paths(tree)}


def _write(final: str, step: int, flat: Dict[str, np.ndarray],
           metadata: Optional[dict], indent: Optional[int]) -> None:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "keys": sorted(flat),
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=indent)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def save_checkpoint(ckpt_dir: str, step: int, tree: Pytree,
                    metadata: Optional[dict] = None) -> str:
    """Synchronous atomic save; returns the final directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    _write(final, step, _flatten_with_paths(tree), metadata, indent=2)
    return final


def list_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            full = os.path.join(ckpt_dir, name)
            if os.path.exists(os.path.join(full, "manifest.json")):
                out.append((int(name[5:]), full))
    return sorted(out)


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    ckpts = list_checkpoints(ckpt_dir)
    for _, path in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(path)


def _rebuild(like: Pytree, data, prefix: Tuple[str, ...]) -> Pytree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, data, prefix + (str(k),))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), data, prefix + (n,))
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(c, data, prefix + (str(i),))
                          for i, c in enumerate(like))
    key = _SEP.join(prefix)
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"{arr.shape} vs {tuple(like.shape)}")
    return _from_savable(arr, like)


def restore_checkpoint(path: str, tree_like: Pytree) -> Tuple[Pytree, dict]:
    """Restore into the structure of ``tree_like`` (shapes must match);
    each leaf takes its template leaf's dtype and device."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        tree = _rebuild(tree_like, data, ())
    return tree, manifest["metadata"]


def restore_latest(ckpt_dir: str, tree_like: Pytree
                   ) -> Optional[Tuple[int, Pytree, dict]]:
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        return None
    step, path = ckpts[-1]
    tree, meta = restore_checkpoint(path, tree_like)
    return step, tree, meta


class AsyncCheckpointer:
    """Background writer: ``save()`` snapshots to the host, then enqueues
    the write."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, flat, metadata = item
            try:
                _write(os.path.join(self.ckpt_dir, f"step_{step:08d}"),
                       step, flat, metadata, indent=None)
                prune_checkpoints(self.ckpt_dir, self.keep)
            except BaseException as e:  # surfaced on next save/wait/close
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _raise(self):
        if self._errors:
            raise RuntimeError(f"async checkpoint failed: {self._errors[0]}")

    def save(self, step: int, tree: Pytree, metadata: Optional[dict] = None):
        self._raise()
        os.makedirs(self.ckpt_dir, exist_ok=True)
        flat = _flatten_with_paths(tree)   # device -> host on this thread
        self._q.put((step, flat, metadata))

    def wait(self):
        """Block until every enqueued save is on disk (the writer stays
        alive)."""
        self._q.join()
        self._raise()

    def close(self):
        self._q.put(None)
        self._thread.join()
        self._raise()
