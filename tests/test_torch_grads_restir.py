"""PyTorch port, the differentiable ReSTIR frame: render_frame with
lighting="restir" and differentiable=True against JAX's value_and_grad on
the CPU, at the frame of tests/test_grads.py:13-20 (TAA and denoise off,
tests/torch_grad_cases.py). A differentiable frame runs the plain
versions of K3-K6 (JAX's own gates, gbuffer.py:295, restir.py:596,
pathtrace.py:722-725).

Tolerances as in test_torch_grads.py: loss 1e-5 relative, gradients rtol
1e-4 with a floor of 1e-6 of the largest entry. Two parameters hold
exact ties: the white material's base_color (0.73, 0.73, 0.73), whose
channels tie in every max of the ReSTIR target function (see
tests/torch_grad_cases.py for the JAX compiles that keep that tie), and
every material's metallic
of exactly 0, which ties with the bound of jnp.clip(metallic, 0, 1)
(jnp.clip passes half the gradient there, torch.clamp all of it: the
port's ops/fp.clip passes half).
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

KW = dict(lighting="restir")


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


def test_metallic_tie_at_zero(grads):
    """metallic = 0 exactly on every material: the gradient is nonzero and
    matches JAX's half-gradient at the clip bound (torch.clamp gave twice
    JAX's)."""
    (_, jg), (_, pg) = grads
    assert np.abs(jg["metallic"]).max() > 1e-3
    assert_grads_close(pg["metallic"], jg["metallic"], "metallic")
