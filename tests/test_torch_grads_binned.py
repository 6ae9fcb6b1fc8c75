"""PyTorch port, the differentiable big-mesh frame through the binned
tracer (tests/torch_big_scene.py at subdiv 3: 1,316 triangles, 742
vertex rows; a ClusterSet accel, cluster_k 32), ReSTIR at 48x32:
render_frame with differentiable=True against JAX's value_and_grad on
the CPU (its binned kernels in interpret mode, stop_gradient-ed as the
port's tracer is), w.r.t. positions, base_color and inst_transform (the
scene has no textures: the trivial atlas's gradient is 0 in both).
"""

import numpy as np
import pytest

from torch_gltf_grad_cases import (
    PARAMS,
    assert_grads_close,
    assert_loss_close,
    binned_frames,
)

KW = dict(lighting="restir", width=48, height=32)


@pytest.fixture(scope="module")
def grads():
    return binned_frames(**KW)


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    assert_loss_close(pl, jl)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    (_, jg), (_, pg) = grads
    assert_grads_close(pg[param], jg[param], param)


def test_gradients_reach_the_mesh(grads):
    """The positions gradient reaches vertices of the icosphere (rows
    past the Cornell box's), where the binned tracer found the hits."""
    (_, jg), (_, pg) = grads
    sphere = pg["positions"][-642:]
    assert np.abs(np.nan_to_num(sphere)).max() > 1e-6
    assert np.abs(pg["base_color"]).max() > 1e-4
