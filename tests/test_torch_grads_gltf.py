"""PyTorch port, the differentiable glTF frame with NEE through the
unified BVH ("bvh": the host SAH build, alpha cutout): render_frame with
differentiable=True against JAX's value_and_grad on the CPU
(tests/torch_gltf_grad_cases.py), w.r.t. positions, base_color,
inst_transform and the atlas's texels.

The reference's gradient is NaN at the glass box's two faces that look
along the camera (vertex rows 32-35 and 40-43) and at its instance
transform (5): the zero cotangent of the last bounce's unused direction
meets a root at 0 (ROADMAP open items); the port's masks are equal.
The ReSTIR frame is in test_torch_grads_gltf_restir.py, edge
antialiasing in test_torch_grads_gltf_aa.py, so that --dist loadfile
compiles the JAX frames in separate workers.
"""

import numpy as np
import pytest

from torch_gltf_grad_cases import (
    PARAMS,
    assert_grads_close,
    assert_loss_close,
    gltf_frames,
    write_glb,
)

KW = dict(lighting="nee", tracer="bvh")


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    return gltf_frames(write_glb(tmp_path_factory), **KW)


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    assert_loss_close(pl, jl)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    (_, jg), (_, pg) = grads
    assert_grads_close(pg[param], jg[param], param)


def test_reference_nan_rows(grads):
    """The NaN rows of both packages: the glass box's faces at z = 1.7
    and 2.7 and its instance; the texels and materials finite."""
    (_, jg), (_, pg) = grads
    for g in (jg, pg):
        assert np.unique(np.nonzero(np.isnan(g["positions"]))[0]).tolist() \
            == [32, 33, 34, 35, 40, 41, 42, 43]
        assert np.unique(np.nonzero(np.isnan(g["inst_transform"]))[0]
                         ).tolist() == [5]
        assert np.isfinite(g["textures"]).all()
        assert np.isfinite(g["base_color"]).all()
    assert np.abs(pg["textures"]).max() > 1e-4
