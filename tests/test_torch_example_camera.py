"""PyTorch port, examples/torch_optimize_camera.py's pose loss against
the JAX examples/optimize_camera.py on the CPU at 24x18 (the example's
config otherwise: NEE, 2 bounces, 1 a-trous pass, TAA off,
differentiable): the loss and its gradient w.r.t. the camera position at
the example's start pose, against jax.jit(jax.value_and_grad). The
gradient reaches the position through camera_matrices (the port's Camera
takes the leaf tensor) and the hit recompute. Bars of
test_torch_grads.py: loss 1e-5 relative, gradient rtol 1e-4 with a floor
of 1e-6 of its largest entry. --joint --edge-aa is
test_torch_example_camera_aa.py.
"""

import numpy as np
import pytest
import torch

from examples import torch_optimize_camera as ex
from torch_example_cases import (
    LOSS_RTOL,
    SIZE,
    assert_grad_close,
    jax_pose_value_and_grad,
)
from torch_parity import n


@pytest.fixture(scope="module")
def pose():
    pb = ex.problem(SIZE, device="cpu")
    params = {k: v.clone().requires_grad_() for k, v in pb.init.items()}
    loss = pb.loss(params)
    grad, = torch.autograd.grad(loss, [params["position"]])
    return jax_pose_value_and_grad(), (float(loss.detach()), n(grad), pb)


def test_start_pose(pose):
    _, (_, _, pb) = pose
    np.testing.assert_array_equal(
        n(pb.init["position"]),
        np.float32((1.0, 1.0, 3.4)) + np.float32((0.25, -0.2, 0.3)))
    assert pb.pose_err(pb.init) == pytest.approx(0.4387, abs=1e-4)


def test_pose_loss_matches_jax(pose):
    (jl, _), (pl, _, _) = pose
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


def test_position_gradient_matches_jax(pose):
    (_, jg), (_, pg, _) = pose
    assert np.isfinite(pg).all()
    assert np.abs(pg).min() > 1e-4 * np.abs(pg).max()   # all three axes
    assert_grad_close(pg, jg["position"], "position")
