"""PyTorch port, nee_boundary_term's gradient against jax.grad on the CPU
(TestCandidatePruning's 256 floor points under the Cornell light,
tests/test_boundary.py:254-283), dense (candidates=0) and pruned
(candidates=8): the gradient of sum(term) w.r.t. the vertex positions
within rtol 1e-4 and a floor of 1e-5 of its largest entry; and w.r.t.
the light geometry (the emissive triangles' vertices, emissive_v), which
the term reaches through the light's normal (n_dark, cnum, y): finite in
both packages and within the same bars.

The whole differentiable frame's gradients with the term on, finite
w.r.t. positions, and what the light geometry gets there, are pinned in
test_torch_boundary_frame.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.render import boundary as jboundary
from sunray_tpu.render import restir as jrestir
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch.render import boundary, restir
from torch_boundary_cases import floor_points, port_scene_of
from torch_parity import n, t

RTOL, FLOOR = 1e-4, 1e-5       # floor: of the largest |gradient| entry
FIELDS = ("positions", "emissive_v")


def _jax_grads(candidates):
    scene = jboundary.with_edge_topology(jcornell_box())
    x, nrm, alb, mask = (jnp.asarray(a) for a in floor_points())

    def loss(pos, ev):
        sc = scene.replace(positions=pos, emissive_v=ev)
        term = jboundary.nee_boundary_term(
            sc, jrestir.Lights(sc), sc.world_triangle_vertices(), x, nrm,
            alb, mask, candidates=candidates)
        return jnp.sum(term)

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(scene.positions,
                                                 scene.emissive_v)
    return {k: np.asarray(v) for k, v in zip(FIELDS, g)}


def _port_grads(candidates):
    scene = boundary.with_edge_topology(port_scene_of(jcornell_box()))
    leaves = {k: getattr(scene, k).clone().requires_grad_() for k in FIELDS}
    sc = dataclasses.replace(scene, **leaves)
    x, nrm, alb, mask = (t(a) for a in floor_points())
    term = boundary.nee_boundary_term(
        sc, restir.Lights(sc), sc.world_triangle_vertices(), x, nrm, alb,
        mask, candidates=candidates)
    assert torch.equal(term, torch.zeros_like(term))
    g = torch.autograd.grad(term.sum(), list(leaves.values()))
    return {k: n(v) for k, v in zip(FIELDS, g)}


@pytest.fixture(scope="module", params=[0, 8], ids=["dense", "pruned"])
def grads(request):
    return _jax_grads(request.param), _port_grads(request.param)


@pytest.mark.parametrize("field", FIELDS)
def test_term_gradient_matches_jax(grads, field):
    jg, pg = grads
    assert np.isfinite(jg[field]).all() and np.isfinite(pg[field]).all()
    scale = float(np.abs(jg[field]).max())
    assert scale > 1e-2
    np.testing.assert_allclose(pg[field], jg[field], rtol=RTOL,
                               atol=FLOOR * scale, err_msg=field)
