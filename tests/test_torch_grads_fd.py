"""PyTorch port, the differentiable frame against central finite
differences: the patterns and tolerances of tests/test_grads.py (base
color, emission strength, camera z, light height) on the port's own
Cornell box, at that file's frame (32x24, bounces=2, virtual_bounces=2,
tonemap="none", no TAA, no denoise) with NEE lighting.

The ReSTIR frame is held to JAX's own gradients instead
(test_torch_grads_restir.py): at these step sizes its central
differences move reservoir picks (base color 17% and camera z 26% off
AD), and its light-table gradient is NaN in both packages (the norm of
the zero vector on lanes that hold no sample, behind a where).

AD carries shading gradients only: the tracer is a discrete oracle
(render/trace.py detaches its inputs), so the finite differences are
taken along directions that move no silhouette at these step sizes, as
test_grads.py chooses them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene import cornell_box
from torch_parity import n

W, H = 32, 24
EYE = (1.0, 1.0, 3.4)


CFG = RenderConfig(width=W, height=H, lighting="nee", bounces=2,
                   virtual_bounces=2, denoise_passes=0, enable_taa=False,
                   differentiable=True, tonemap="none")


@pytest.fixture(scope="module")
def scene():
    return cornell_box(device="cpu")


def render_loss(scene, cfg, eye=EYE):
    """Mean of one frame's ldr; eye may be a (3,) tensor in a graph."""
    mats = camera_matrices(Camera(position=eye, target=(1.0, 1.0, 0.0),
                                  fov_y=45.0), W, H, device="cpu")
    _, ldr, _ = render_frame(scene, cfg, RenderState.create(cfg, "cpu"),
                             mats)
    return ldr.mean()


def _with(scene, **fields):
    mats = {k: v for k, v in fields.items()
            if k in ("base_color", "emissive_factor")}
    rest = {k: v for k, v in fields.items() if k not in mats}
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **mats), **rest)


def _fd(f, x0, eps):
    with torch.no_grad():
        return (float(f(x0 + eps)) - float(f(x0 - eps))) / (2 * eps)


def test_base_color_fd(scene):
    """The white material's red channel and the green wall's green
    (test_grads.py:49-77), rtol 0.15."""
    cfg = CFG
    base = scene.materials.base_color
    bc = base.clone().requires_grad_()
    g_ad = n(torch.autograd.grad(render_loss(_with(scene, base_color=bc),
                                             cfg), bc)[0])
    assert np.isfinite(g_ad).all()
    for prim, chan in [(0, 0), (2, 1)]:
        def f(v, prim=prim, chan=chan):
            b = base.clone()
            b[prim, chan] = v
            return render_loss(_with(scene, base_color=b), cfg)
        fd = _fd(f, float(base[prim, chan]), 1e-2)
        assert fd != 0.0
        np.testing.assert_allclose(g_ad[prim, chan], fd, rtol=0.15)


def test_emission_strength_fd(scene):
    """d loss / d strength of the light material (test_grads.py:79-99)."""
    cfg = CFG
    ef0 = scene.materials.emissive_factor
    prim = scene.emissive_prim.long()

    def loss(e):
        rgb = e[prim, :3] * e[prim, 3:4]
        return render_loss(_with(scene, emissive_factor=e, emissive_rgb=rgb),
                           cfg)

    ef = ef0.clone().requires_grad_()
    g_ad = float(torch.autograd.grad(loss(ef), ef)[0][3, 3])
    assert np.isfinite(g_ad)

    def f(v):
        e = ef0.clone()
        e[3, 3] = v
        return loss(e)

    fd = _fd(f, float(ef0[3, 3]), 0.1)
    assert fd > 0.0            # a brighter light, a brighter image
    np.testing.assert_allclose(g_ad, fd, rtol=0.15)


def test_camera_z_fd(scene):
    """The dolly direction (test_grads.py:102-120), rtol 0.1: the eye is a
    tensor in the graph of camera_matrices."""
    cfg = CFG
    eye = torch.tensor(EYE, requires_grad=True)
    g_ad = n(torch.autograd.grad(render_loss(scene, cfg, eye), eye)[0])
    assert np.isfinite(g_ad).all()

    def f(z):
        return render_loss(scene, cfg, torch.tensor((EYE[0], EYE[1], z)))

    fd = _fd(f, EYE[2], 2e-3)
    np.testing.assert_allclose(g_ad[2], fd, rtol=0.1)


def test_light_height_fd(scene):
    """Moving the light's vertices (and its emissive triangles) down
    brightens the box (test_grads.py:123-147), rtol 0.3."""
    cfg = CFG
    light_prim = int(scene.emissive_prim[0])
    owner = scene.inst_prim[scene.tri_inst.long()] == light_prim
    verts = torch.unique(scene.tri_vidx[owner].long())

    def loss(dy):
        shift = torch.zeros_like(scene.positions)
        shift[verts, 1] = 1.0
        em_shift = torch.zeros_like(scene.emissive_v)
        em_shift[:, :, 1] = 1.0
        return render_loss(_with(scene,
                                 positions=scene.positions + shift * dy,
                                 emissive_v=scene.emissive_v + em_shift * dy),
                           cfg)

    dy = torch.zeros((), requires_grad=True)
    g_ad = float(torch.autograd.grad(loss(dy), dy)[0])
    assert np.isfinite(g_ad)
    fd = _fd(loss, 0.0, 5e-3)
    assert fd != 0.0
    np.testing.assert_allclose(g_ad, fd, rtol=0.3)
