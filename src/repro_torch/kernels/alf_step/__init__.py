"""Fused ALF state-update kernels: forward step and MALI backward step."""
