"""Optimizers (AdamW with bf16 moments and a float32 master copy, SGD)
and int8 error-feedback gradient compression."""
from .compression import (EFState, compress_grads, compressed_bytes,
                          dequantize_int8, init_ef_state, quantize_int8)
from .optimizer import (OptimizerConfig, OptState, apply_updates,
                        clip_by_global_norm, global_norm, init_opt_state,
                        lr_schedule)

__all__ = ["OptimizerConfig", "OptState", "apply_updates",
           "init_opt_state", "lr_schedule", "global_norm",
           "clip_by_global_norm", "EFState", "compress_grads",
           "init_ef_state", "quantize_int8", "dequantize_int8",
           "compressed_bytes"]
