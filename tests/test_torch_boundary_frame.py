"""PyTorch port, the differentiable NEE frame with the shadow-boundary
term, dense (shadow_boundary_grads=True, candidates=0, the config
default): render_frame against JAX's value_and_grad on the CPU at the
frame of tests/test_grads.py:13-20 (tests/torch_grad_cases.py), both
scenes with their edge topology. Bars as in test_torch_grads.py: loss
1e-5 relative; gradients w.r.t. base_color, metallic and positions
within rtol 1e-4 and a floor of 1e-6 of the largest entry. The term is
zero in the forward pass, so the loss is the frame's without it, and it
moves the positions gradient.

The pruned ReSTIR frame is in test_torch_boundary_frame_restir.py, the
frames with edge antialiasing in test_torch_antialias_frame*.py, one JAX
frame a file so that --dist loadfile spreads the compiles.
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

KW = dict(lighting="nee", shadow_boundary_grads=True)


@pytest.fixture(scope="module")
def grads():
    return (jax_value_and_grads(topology=True, **KW),
            port_value_and_grads(topology=True, **KW))


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    (_, jg), (_, pg) = grads
    assert np.isfinite(pg[param]).all()
    assert_grads_close(pg[param], jg[param], param)


def test_term_is_zero_forward_and_moves_positions(grads):
    (_, _), (pl, pg) = grads
    off_l, off_g = port_value_and_grads(topology=True, lighting="nee")
    assert pl == off_l
    moved = np.abs(pg["positions"] - off_g["positions"]).max()
    assert moved > 0.05 * np.abs(off_g["positions"]).max()
    np.testing.assert_array_equal(pg["base_color"], off_g["base_color"])
