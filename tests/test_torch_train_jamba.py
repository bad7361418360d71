"""The port's LM training loss and gradient for the jamba-v0.1-52b smoke
config (one period: Mamba, attention, MoE) on the CPU against the JAX
package, with the ODE off and with MALI; the bars and the noise-floor
rule of ``tests/test_torch_train_moe_lm.py``, which holds the Naive
mode."""
import pytest

from test_torch_train_moe_lm import check_case


@pytest.mark.parametrize("mode", ["off", "mali"])
def test_jamba_loss_and_grads_match_jax(mode):
    check_case("jamba-v0.1-52b", mode, n_periods=1)
