"""PyTorch port, the differentiable ReSTIR frame with per-pixel spatial
taps (spatial_taps="perpixel", the reference-exact estimator of
sunray_tpu/config.py:162-170): render_frame with differentiable=True
against JAX's value_and_grad on the CPU, at the frame of
tests/test_grads.py:13-20 (TAA and denoise off, tests/torch_grad_cases.py).
The per-pixel taps run as plain PyTorch, their gradients through the
gathers and merges as JAX's run through jnp.

Tolerances as in test_torch_grads_restir.py: the loss within 1e-5
relative, each gradient within rtol 1e-4 with a floor of 1e-6 of its
largest entry, NaN masks equal; the white material's tied base_color row
with the tie split XLA rounds in removed (test_gradient_matches_jax).
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

KW = dict(lighting="restir", spatial_taps="perpixel")


WHITE = 0  # scene/procedural.py's first material, base_color (0.73, 0.73, 0.73)


@pytest.fixture(scope="module")
def grads():
    return jax_value_and_grads(**KW), port_value_and_grads(**KW)


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    """Every entry within the bars, the white base_color row after its
    tie split: the white material ties its three channels in every channel
    max of the target function, and here JAX's compile (of base_color
    alone as well as with metallic) rounds one tied channel an ulp apart,
    which sends the tie's whole gradient to it: the row moves by
    a * (1, 1, -2) (tests/test_torch_grads_tie.py reads the same move in
    the shared-tap frame's joint compile). The port splits the tie
    evenly, as un-jitted JAX does. So that row is held with its
    a * (1, 1, -2) component removed, and a is reported."""
    (_, jg), (_, pg) = grads
    got, want = pg[param].copy(), jg[param]
    if param == "base_color":
        d = want[WHITE, :3] - got[WHITE, :3]
        a = float(d[0] + d[1] - 2.0 * d[2]) / 6.0
        got[WHITE, :3] += a * np.array([1.0, 1.0, -2.0], np.float32)
        print(f"white row tie move a = {a:.3e}")
    assert_grads_close(got, want, param)


def test_gradients_reach_the_materials(grads):
    (_, _), (_, pg) = grads
    assert np.abs(pg["base_color"]).max() > 1e-3
    assert np.abs(pg["positions"]).max() > 1e-3
