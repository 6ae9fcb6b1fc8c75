"""PyTorch port, the differentiable glTF frame with both visibility
terms over tables above 512 rows: edge antialiasing (render/antialias.py:
the winning triangles' world vertices gathered from the 1,024-triangle
table through K8) and the shadow-boundary term with its top-8 candidates
(render/boundary.py: the candidates' endpoints gathered from the scene's
edge table, above 512 edges, through K8; O(P E), so held at this small
size only), K8's backward being the runs path on the card: NEE through
tracer="bvh", against JAX's value_and_grad on the CPU
(tests/torch_gltf_grad_cases.py), w.r.t. positions, base_color,
inst_transform and the atlas's texels, NaN masks equal.
"""

import pytest

from torch_gltf_grad_cases import (
    PARAMS,
    assert_grads_close,
    assert_loss_close,
    gltf_frames,
    write_glb,
)

KW = dict(lighting="nee", tracer="bvh", edge_antialias=True,
          shadow_boundary_grads=True, shadow_boundary_candidates=8)


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    return gltf_frames(write_glb(tmp_path_factory), topology=True, **KW)


def test_tables_above_the_shared_memory_kernel(tmp_path_factory):
    """The GLB's triangle and edge tables both pass MAX_ROWS."""
    from sunray_tpu_torch.ops.cuda_gather import MAX_ROWS
    from sunray_tpu_torch.render import boundary
    from sunray_tpu_torch.scene.gltf import load_gltf

    scene = boundary.with_edge_topology(
        load_gltf(write_glb(tmp_path_factory), device="cpu"))
    assert scene.num_tris > MAX_ROWS
    assert scene.edge_tri.shape[0] > MAX_ROWS


def test_loss_matches_jax(grads):
    (jl, _), (pl, _) = grads
    assert_loss_close(pl, jl)


@pytest.mark.parametrize("param", PARAMS)
def test_gradient_matches_jax(grads, param):
    (_, jg), (_, pg) = grads
    assert_grads_close(pg[param], jg[param], param)
