"""Deterministic synthetic data, bit-equal to the JAX package's."""
from .synthetic import DataConfig, make_batch, make_image_batch

__all__ = ["DataConfig", "make_batch", "make_image_batch"]
