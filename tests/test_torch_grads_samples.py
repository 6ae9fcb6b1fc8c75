"""PyTorch port, the differentiable NEE frame with two samples a pixel:
render_frame with samples=2 and differentiable=True against JAX's
value_and_grad on the CPU, at the frame of tests/test_grads.py:13-20
(tests/torch_grad_cases.py). The second final pass runs on its salted PCG
stream and the raw colours are averaged (JAX pipeline.py:76-92), so the
gradient flows through both passes.

Tolerances as in test_torch_grads.py: the loss within 1e-5 relative, each
gradient within rtol 1e-4 with a floor of 1e-6 of its largest entry, NaN
where JAX has NaN and nowhere else (assert_allclose compares NaN masks).
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

KW = dict(lighting="nee", samples=2)


@pytest.fixture(scope="module")
def grads():
    return jax_value_and_grads(**KW), port_value_and_grads(**KW)


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    (_, jg), (_, pg) = grads
    assert_grads_close(pg[param], jg[param], param)


def test_second_sample_moves_the_loss(grads):
    """Two salted samples are not one sample twice: the loss differs from
    the one-sample frame's."""
    (_, _), (pl, _) = grads
    one, _ = port_value_and_grads(lighting="nee")
    assert pl != one
