"""Model substrate, serve path: attention, Mamba and MoE blocks + the
continuous-depth LM (prefill / decode); the CNF's MLP vector field."""
from .lm import (ServeState, decode_step, init_lm, init_serve_state,
                 prefill)
from .transformer import init_blocks, init_cache, n_cache_slots
from .vfield import init_mlp_vfield, mlp_vfield

__all__ = ["init_lm", "prefill", "decode_step", "init_serve_state",
           "ServeState", "init_blocks", "init_cache", "n_cache_slots",
           "init_mlp_vfield", "mlp_vfield"]
