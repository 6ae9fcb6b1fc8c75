"""PyTorch port, the differentiable NEE frame: render_frame with
differentiable=True against JAX's value_and_grad on the CPU, at the
frame of tests/test_grads.py:13-20 (tests/torch_grad_cases.py).

Tolerances: the loss within 1e-5 relative (the port rounds the frame as
XLA's CPU backend does, ops/fp.py; the losses agree to ~7e-6); each
gradient elementwise within rtol 1e-4 with an absolute floor of 1e-6 of
its largest entry (the backward sums in other orders than XLA's, and a
few entries are float dust in one package and exact zeros in the other).
The ReSTIR frame is in test_torch_grads_restir.py, so that
--dist loadfile compiles the two JAX frames in two workers.
"""

import numpy as np
import pytest

from torch_grad_cases import (
    LOSS_RTOL,
    PARAMS,
    assert_grads_close,
    jax_value_and_grads,
    port_value_and_grads,
)

KW = dict(lighting="nee")


@pytest.fixture(scope="module")
def grads():
    return jax_value_and_grads(**KW), port_value_and_grads(**KW)


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    (_, jg), (_, pg) = grads
    assert np.isfinite(pg[param]).all()
    assert_grads_close(pg[param], jg[param], param)


def test_gradients_reach_every_parameter(grads):
    """base_color and positions carry a gradient; metallic is 0 in both
    packages on this frame (only the ReSTIR target function reads it)."""
    (_, jg), (_, pg) = grads
    assert np.abs(pg["base_color"]).max() > 1e-3
    assert np.abs(pg["positions"]).max() > 1e-3
    np.testing.assert_array_equal(pg["metallic"], jg["metallic"])
