"""PyTorch port, the gradient w.r.t. the light geometry (the emissive
triangles' vertices, emissive_v) with the shadow-boundary term on.

The term reaches the light through its normal: the curve tangent's
in-plane normal n0 = cross(nl_u, dy/ds) / |...| reads the live normal.
On a lane whose shading point lies on the light's plane (the light quad
itself is a rough NEE surface) the projection parameter t is 0, so
dy/ds = 0 and the norm's derivative is infinite: zero times infinity
gives NaN, behind the masks. The reference does the same, so the port
keeps it (ROADMAP Queue 3, with the ReSTIR frame's light-table NaN):

- the 32x24 NEE frame (tests/torch_grad_cases.py), dense term: NaN in
  every entry in both packages; without the term finite in both and
  within rtol 1e-4 (floor 1e-6 of the largest entry) of JAX's;
- nee_boundary_term at the 256 floor points plus one point on the
  light: NaN in both packages (the floor points alone are finite,
  test_torch_boundary_grad.py); the positions gradient stays finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.render import boundary as jboundary
from sunray_tpu.render import restir as jrestir
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render import boundary, restir
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from torch_boundary_cases import floor_points
from torch_grad_cases import (
    CAMERA,
    GRAD_KW,
    H,
    W,
    JCamera,
    JConfig,
    JState,
    assert_grads_close,
    jax_scene,
    jcamera_matrices,
    jrender_frame,
    port_mats,
    port_scene,
)
from torch_parity import n, t


def _jax_light_grad(**kw):
    cfg = JConfig(**dict(GRAD_KW, **kw))
    scene = jax_scene(topology=True)
    mats = jcamera_matrices(JCamera(**CAMERA), W, H)

    def loss(ev):
        _, ldr, _ = jrender_frame(scene.replace(emissive_v=ev), cfg,
                                  JState.create(cfg), mats)
        return jnp.mean(ldr)

    return np.asarray(jax.jit(jax.grad(loss))(scene.emissive_v))


def _port_light_grad(**kw):
    cfg = RenderConfig(**dict(GRAD_KW, **kw))
    scene, _ = port_scene(requires_grad=(), topology=True)
    ev = scene.emissive_v.clone().requires_grad_()
    _, ldr, _ = render_frame(dataclasses.replace(scene, emissive_v=ev), cfg,
                             RenderState.create(cfg, "cpu"), port_mats())
    return n(torch.autograd.grad(ldr.mean(), ev)[0])


@pytest.mark.parametrize("term", [False, True], ids=["off", "on"])
def test_frame_light_gradient_against_jax(term):
    kw = dict(lighting="nee", shadow_boundary_grads=term)
    jg, pg = _jax_light_grad(**kw), _port_light_grad(**kw)
    if term:
        assert np.isnan(jg).all() and np.isnan(pg).all()
    else:
        assert np.isfinite(pg).all()
        assert_grads_close(pg, jg, "emissive_v")


def test_point_on_the_light_makes_the_light_gradient_nan():
    x, nrm, alb, mask = floor_points()
    x = np.concatenate([x, np.float32([[1.0, 1.99, 1.0]])])   # on the light
    nrm = np.concatenate([nrm, np.float32([[0.0, -1.0, 0.0]])])
    alb = np.concatenate([alb, alb[:1]])
    mask = np.concatenate([mask, [True]])
    scene = jax_scene(topology=True)

    def loss(pos, ev):
        sc = scene.replace(positions=pos, emissive_v=ev)
        term = jboundary.nee_boundary_term(
            sc, jrestir.Lights(sc), sc.world_triangle_vertices(),
            jnp.asarray(x), jnp.asarray(nrm), jnp.asarray(alb),
            jnp.asarray(mask))
        return jnp.sum(term)

    j_pos, j_ev = jax.jit(jax.grad(loss, argnums=(0, 1)))(scene.positions,
                                                           scene.emissive_v)
    ps, _ = port_scene(requires_grad=(), topology=True)
    pos = ps.positions.clone().requires_grad_()
    ev = ps.emissive_v.clone().requires_grad_()
    sc = dataclasses.replace(ps, positions=pos, emissive_v=ev)
    term = boundary.nee_boundary_term(
        sc, restir.Lights(sc), sc.world_triangle_vertices(), t(x), t(nrm),
        t(alb), t(mask))
    p_pos, p_ev = torch.autograd.grad(term.sum(), (pos, ev))
    assert np.isnan(np.asarray(j_ev)).any() and np.isnan(n(p_ev)).any()
    assert np.isfinite(np.asarray(j_pos)).all()
    assert torch.isfinite(p_pos).all()
