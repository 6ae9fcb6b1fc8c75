"""PyTorch port, examples/torch_optimize_camera.py --joint --edge-aa
against the JAX examples/optimize_camera.py on the CPU at 24x18: the pose
loss and its gradients w.r.t. the camera position and look-at target at
the example's start pose, against jax.jit(jax.value_and_grad).

Edge antialiasing's crossings at pixel centres decide on their last bit,
and the reference's compiles round them apart (ROADMAP Queue 3): its
target frame comes from the forward compile, its loss and gradient from
the gradient compile, which fuses the crossing's numerator scale too. So
the port renders the target as it renders (the forward compile's
rounding) and takes the loss and gradient with
torch_boundary_cases.gradient_compile_crossing patched in, as
test_torch_antialias_frame.py does. Bars of test_torch_grads.py.
"""

import numpy as np
import pytest
import torch

from examples import torch_optimize_camera as ex
from sunray_tpu_torch.render import antialias
from torch_boundary_cases import gradient_compile_crossing
from torch_example_cases import (
    LOSS_RTOL,
    SIZE,
    assert_grad_close,
    jax_pose_value_and_grad,
)
from torch_parity import n


def port_value_and_grad():
    pb = ex.problem(SIZE, edge_aa=True, joint=True, device="cpu")
    params = {k: v.clone().requires_grad_() for k, v in pb.init.items()}
    inner = antialias._edge_crossing
    antialias._edge_crossing = gradient_compile_crossing
    try:
        loss = pb.loss(params)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        antialias._edge_crossing = inner
    return float(loss.detach()), {k: n(g) for k, g in zip(params, grads)}


@pytest.fixture(scope="module")
def pose():
    return (jax_pose_value_and_grad(edge_aa=True, joint=True),
            port_value_and_grad())


def test_pose_loss_matches_jax(pose):
    (jl, _), (pl, _) = pose
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@pytest.mark.parametrize("param", ["position", "target"])
def test_pose_gradient_matches_jax(pose, param):
    (_, jg), (_, pg) = pose
    assert np.isfinite(pg[param]).all()
    assert np.abs(pg[param]).max() > 0.0
    assert_grad_close(pg[param], jg[param], param)


def test_edge_aa_moves_the_pose_gradient(pose):
    _, (_, pg) = pose
    pb = ex.problem(SIZE, joint=True, device="cpu")
    params = {k: v.clone().requires_grad_() for k, v in pb.init.items()}
    off = torch.autograd.grad(pb.loss(params), [params["position"]])[0]
    assert np.abs(pg["position"] - n(off)).max() > 1e-3 * np.abs(n(off)).max()
