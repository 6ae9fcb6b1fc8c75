"""PyTorch port, the shadow-boundary term's host topology and candidate
selection (render/boundary.py, ops/cuda_boundary.py) against the JAX
package on the CPU.

- build_edge_topology: the port's numpy copy gives JAX's arrays on the
  Cornell box (64 edges, 20 open, tests/test_boundary.py:56-79) and on
  the floating-box scene.
- B1's plain version (boundary_candidates_plain, what the CPU runs and
  the card's kernel is held to) against the reference's selection
  (_candidate_score and K argmax extractions, jitted): identical edge
  indices, live counts, silhouette flags and side-reference faces at
  TestCandidatePruning's 256 floor points and at the first-rough hits of
  the 32x24 ReSTIR frame (tests/torch_grad_cases.py).
- nee_boundary_term: exactly zero in the forward pass; pruned (K=8)
  against dense within 1e-5 of the largest gradient entry
  (tests/test_boundary.py:268-283).
The gradient against JAX is in test_torch_boundary_grad.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sunray_tpu.render import boundary as jboundary
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_boundary, cuda_build
from sunray_tpu_torch.render import boundary, restir
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from torch_boundary_cases import (
    floor_points,
    jax_floating_scene,
    jax_selection,
    port_scene_of,
)
from torch_grad_cases import GRAD_KW, port_mats
from torch_parity import n, t

K = 8


@pytest.fixture(scope="module")
def cornell():
    js = jboundary.with_edge_topology(jcornell_box())
    return js, boundary.with_edge_topology(port_scene_of(jcornell_box()))


@pytest.mark.parametrize("name", ["cornell", "floating"])
def test_edge_topology_matches_jax(name):
    jscene = jcornell_box() if name == "cornell" else jax_floating_scene()
    et, ek = boundary.build_edge_topology(port_scene_of(jscene))
    jet, jek = jboundary.build_edge_topology(jscene)
    assert et.dtype == ek.dtype == torch.int32
    np.testing.assert_array_equal(n(et), np.asarray(jet))
    np.testing.assert_array_equal(n(ek), np.asarray(jek))
    if name == "cornell":
        assert et.shape == (64, 2)
        assert int((et[:, 1] < 0).sum()) == 20


def _selection(scene, x, mask, k=K):
    lights = restir.Lights(scene)
    _, _, table, _, _ = boundary._edge_geometry(
        scene.world_triangle_vertices(), scene.edge_tri, scene.edge_k)
    lt = cuda_boundary.light_table(lights.v0, lights.v1, lights.v2)
    return cuda_boundary.boundary_candidates(t(x), t(mask), table, lt, k)


def _assert_selection_equal(got, want):
    for li, w in enumerate(want):
        for name, g, wa in zip(("idx", "n_live", "sil", "face2"), got, w):
            np.testing.assert_array_equal(n(g[li]), wa,
                                          err_msg=f"light {li} {name}")


def test_plain_selection_matches_jax_on_floor_points(cornell):
    js, ps = cornell
    x, _, _, mask = floor_points()
    got = _selection(ps, x, mask)
    assert tuple(got[0].shape) == (2, K, 256)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    assert int(got[1].max()) > 0      # live candidates exist
    _assert_selection_equal(got, jax_selection(js, x, mask, K))


@pytest.fixture(scope="module")
def frame_hits(cornell):
    """The first-rough hits (x, nee_mask) that the 32x24 differentiable
    ReSTIR frame hands the boundary term."""
    _, ps = cornell
    seen = []
    inner = boundary.nee_boundary_term

    def spy(scene, lights, tris_w, x, normal, albedo, nee_mask, *args):
        seen.append((n(x), n(nee_mask)))
        return inner(scene, lights, tris_w, x, normal, albedo, nee_mask, *args)

    cfg = RenderConfig(**dict(GRAD_KW, lighting="restir",
                              shadow_boundary_grads=True,
                              shadow_boundary_candidates=K))
    boundary.nee_boundary_term = spy
    try:
        render_frame(ps, cfg, RenderState.create(cfg, "cpu"), port_mats())
    finally:
        boundary.nee_boundary_term = inner
    assert len(seen) == 1
    return seen[0]


def test_plain_selection_matches_jax_on_frame_hits(cornell, frame_hits):
    js, ps = cornell
    x, mask = frame_hits
    assert mask.sum() > 100
    got = _selection(ps, x, mask)
    assert int(got[1].max()) > 0
    _assert_selection_equal(got, jax_selection(js, x, mask, K))


def test_selection_order_ties_by_edge_index(cornell):
    """Ranks past the live count continue in edge order over the zero
    scores, as argmax's first index does; a masked lane has no live
    candidate."""
    _, ps = cornell
    x, _, _, mask = floor_points(16)
    mask[3] = False
    idx, n_live, _, _ = _selection(ps, x, mask, k=12)
    assert int(n_live[:, 3].max()) == 0
    np.testing.assert_array_equal(n(idx[:, :, 3]),
                                  np.tile(np.arange(12), (2, 1)))
    for li in range(2):
        for p in range(16):
            tail = n(idx[li, int(n_live[li, p]):, p])
            assert (np.diff(tail) > 0).all()


def test_wrapper_checks_its_arguments(cornell):
    _, ps = cornell
    x, _, _, mask = floor_points(8)
    with pytest.raises(cuda_build.KernelError):
        _selection(ps, x, mask, k=64)          # k must be below E
    with pytest.raises(cuda_build.KernelError):
        cuda_boundary.boundary_candidates(t(x[:, :2]), t(mask),
                                          torch.zeros((4, 24)),
                                          torch.zeros((1, 12)), 2)


def _term_grad(scene, candidates):
    x, nrm, alb, mask = floor_points()
    pos = scene.positions.clone().requires_grad_()
    sc = dataclasses.replace(scene, positions=pos)
    term = boundary.nee_boundary_term(
        sc, restir.Lights(sc), sc.world_triangle_vertices(), t(x), t(nrm),
        t(alb), t(mask), candidates=candidates)
    g, = torch.autograd.grad(term.sum(), pos)
    return term, n(g)


def test_term_forward_is_zero_and_pruned_matches_dense(cornell):
    _, ps = cornell
    term0, gd = _term_grad(ps, 0)
    term8, gp = _term_grad(ps, K)
    assert torch.equal(term0, torch.zeros_like(term0))
    assert torch.equal(term8, torch.zeros_like(term8))
    scale = np.abs(gd).max()
    assert scale > 1.0        # the term carries gradient
    np.testing.assert_allclose(gp, gd, atol=1e-5 * scale)
