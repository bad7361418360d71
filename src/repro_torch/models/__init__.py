"""Model substrate: attention, Mamba, xLSTM and MoE blocks + the
continuous-depth LM (its training loss, prefill and decode); the CNF's MLP
vector field."""
from .lm import (ServeState, backbone_train, chunked_ce_loss, decode_step,
                 init_lm, init_serve_state, lm_loss, lm_loss_and_stats,
                 prefill)
from .transformer import (blocks_train, init_blocks, init_cache,
                          n_cache_slots)
from .vfield import init_mlp_vfield, mlp_vfield

__all__ = ["init_lm", "lm_loss", "lm_loss_and_stats", "backbone_train",
           "chunked_ce_loss", "prefill", "decode_step", "init_serve_state",
           "ServeState", "blocks_train", "init_blocks", "init_cache",
           "n_cache_slots", "init_mlp_vfield", "mlp_vfield"]
