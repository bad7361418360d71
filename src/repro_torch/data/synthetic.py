"""Deterministic synthetic data: every batch is a pure function of
``(seed, step, shard)``.

The same numpy code as the JAX package's ``repro.data.synthetic``, so
both packages draw bit-equal batches from the same ``(seed, step,
shard)``; the caller moves them to the device. Token streams are
Zipf-ish (heavy-headed) so cross-entropy losses are non-degenerate;
'embeds' mode draws Gaussian frame/patch embeddings; image batches are
the CNF's MNIST-shaped feed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128


def _shard_key(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def make_batch(cfg: ModelConfig, dcfg: DataConfig, step: int,
               shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """One shard of one step's global batch, as host numpy."""
    assert dcfg.global_batch % n_shards == 0
    b = dcfg.global_batch // n_shards
    rng = _shard_key(dcfg.seed, step, shard)
    s = dcfg.seq_len
    if cfg.input_mode == "embeds":
        emb = rng.standard_normal((b, s, cfg.d_model), np.float32) * 0.02
        labels = rng.zipf(1.5, (b, s)).clip(1, cfg.vocab_size) - 1
        return {"embeds": emb, "labels": labels.astype(np.int32)}
    toks = rng.zipf(1.5, (b, s + 1)).clip(1, cfg.vocab_size) - 1
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_image_batch(dcfg: DataConfig, step: int, shard: int = 0,
                     n_shards: int = 1,
                     shape: tuple = (28, 28, 1)) -> Dict[str, np.ndarray]:
    """One shard of one step's MNIST-shaped image batch (the CNF's data
    feed), as host numpy: smooth multi-blob intensity fields quantized to
    256 levels in [0, 1), flattened to ``{"image": (b, H*W*C) float32}``.
    """
    assert dcfg.global_batch % n_shards == 0
    b = dcfg.global_batch // n_shards
    rng = _shard_key(dcfg.seed, step, shard)
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    centers = rng.uniform(0, [h, w], (b, 3, 2)).astype(np.float32)
    widths = rng.uniform(h / 10, h / 4, (b, 3)).astype(np.float32)
    img = np.zeros((b, h, w), np.float32)
    for k in range(3):
        d2 = ((yy[None] - centers[:, k, 0, None, None]) ** 2
              + (xx[None] - centers[:, k, 1, None, None]) ** 2)
        img += np.exp(-d2 / (2 * widths[:, k, None, None] ** 2))
    img /= img.max(axis=(1, 2), keepdims=True).clip(1e-6)
    img = np.floor(img * 255.0) / 256.0  # 256-level quantization grid
    img = np.repeat(img[..., None], c, axis=-1)
    return {"image": img.reshape(b, h * w * c).astype(np.float32)}
