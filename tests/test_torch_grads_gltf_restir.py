"""PyTorch port, the differentiable glTF frame with ReSTIR through
tracer="auto" (on this GLB the two-level BVH, a BlasSet accel; alpha
cutout): render_frame with differentiable=True against JAX's
value_and_grad on the CPU (tests/torch_gltf_grad_cases.py), w.r.t.
positions, base_color, inst_transform and the atlas's texels. Equal NaN
masks: the glass box's faces and instance as in the NEE frame
(test_torch_grads_gltf.py), and the light's instance (4), the light-table
NaN of both packages (ROADMAP open items).
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

KW = dict(lighting="restir", tracer="auto")


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


def test_reference_nan_instances(grads):
    (_, jg), (_, pg) = grads
    for g in (jg, pg):
        assert np.unique(np.nonzero(np.isnan(g["inst_transform"]))[0]
                         ).tolist() == [4, 5]
        assert np.isfinite(g["textures"]).all()
    assert np.abs(pg["textures"]).max() > 1e-4
