"""``adv_dtype=float32`` under a float64 main pass (dct_tpu's
``Trainer.adv_dtype``: the FGSM segment, its generation forward, input
gradient, sign step and adversarial forward, in its own dtype), held
against ``dct_tpu.train.steps.make_cotrain_epoch`` with the same setting,
on the CPU: the setting, weights, data and helpers of
``test_torch_fused_forward.py``. One dct_tpu epoch is compiled.
"""
import numpy as np
import pytest
import torch

from test_torch_fused_forward import QUANTITIES, data, difference, jax_epoch, port_epoch  # noqa: F401
from test_torch_jaxref import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def adv_fp32(data):
    """dct_tpu's and the port's fused step with the FGSM segment in fp32
    under a float64 main pass, and the port's all-float64 step."""
    ref = jax_epoch(data, adv_dtype="float32")
    return {"jax": ref, "port": port_epoch(data, ref["thetas"], adv_dtype=torch.float32),
            "port_f64": port_epoch(data, ref["thetas"])}


# With the FGSM segment in fp32 the main pass stays float64: the
# supervised and JSD losses, and model 1 (b, attacked, which takes no
# gradient from the segment), agree with dct_tpu's same setting as in the
# all-float64 step. The adversarial loss, model 0's (a) parameters and
# both models' statistics (b's generation forward and a's adversarial
# forward run in fp32) carry each framework's fp32 rounding, where FGSM's
# sign turns it into flips: at 32² dct_tpu's fp32 CPU input gradient is
# ~4 % of its scale off float64 (test_torch_slice.py), and its fp32-segment
# adversarial loss lies 8.8e-4 from its float64 one (measured), the port's
# 3.4e-7. So those are held to dct_tpu's own, as the bf16 forward is in
# test_torch_slice.py: the port's fp32-segment result may lie no further
# from dct_tpu's than 1.5× dct_tpu's fp32-segment result lies from the
# float64 step, the port's, which test_torch_fused_forward.py holds to
# dct_tpu's float64 step (model 0's parameters: 9.106e-4 against
# 9.103e-4, measured).
ADV_MAIN_PASS = {"sup_loss": 1e-5, "jsd_loss": 1e-5, "params_1": 1e-6}


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_adv_dtype_float32_matches_dct_tpu(adv_fp32, quantity):
    got = difference(adv_fp32["jax"], adv_fp32["port"], quantity)
    if quantity in ADV_MAIN_PASS:
        assert got <= ADV_MAIN_PASS[quantity]
    else:
        own = difference(adv_fp32["port_f64"], adv_fp32["jax"], quantity)
        assert 0 < own and got <= 1.5 * own, (got, own)


def test_adv_dtype_float32_runs_the_segment_in_fp32(adv_fp32):
    """The fp32 segment moves the adversarial loss off the float64 one by
    fp32 rounding, not more, and leaves the supervised loss as it was."""
    got, ref = adv_fp32["port"]["metrics"], adv_fp32["port_f64"]["metrics"]
    np.testing.assert_array_equal(got["sup_loss"], ref["sup_loss"])
    assert 0 < abs(float(got["adv_loss"][0] - ref["adv_loss"][0])) < 1e-4
