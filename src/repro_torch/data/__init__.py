"""Deterministic synthetic data, bit-equal to the JAX package's."""
from .synthetic import (DataConfig, SyntheticStream, batch_to_device,
                        make_batch, make_image_batch)

__all__ = ["DataConfig", "SyntheticStream", "batch_to_device", "make_batch",
           "make_image_batch"]
