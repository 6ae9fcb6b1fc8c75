"""PyTorch port, primary edge antialiasing (render/antialias.py) against
the JAX package on the CPU, after tests/test_antialias.py:

- the projection convention: a pixel's primary hit projects back to its
  centre (within 5e-2 px, :34-55);
- primary_edge_aa on a seeded image with the 32x24 Cornell frame's
  primary hits: the image of JAX's jitted pass (within 1e-6), and the
  pass touching only silhouette pixels (0 < share changed < 0.35,
  :66-76);
- the noise-free occluder fixture (:79-112, two emissive quads; the scene
  comes from JAX's SceneManager as numpy): without edge antialiasing
  d loss / d (occluder x) is zero, with it the gradients w.r.t. the
  occluder's x shift and the camera's x match jax.grad's (rtol 1e-4)
  and are negative and positive as the reference finds (:115-167).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.camera import generate_rays as jgenerate_rays
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.render import antialias as jantialias
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu.render.trace import make_tracer as jmake_tracer
from sunray_tpu.render.trace import trace_closest as jtrace_closest
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.camera import Camera, camera_matrices, generate_rays
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render import antialias
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.render.trace import make_tracer, trace_closest
from torch_boundary_cases import port_scene_of
from torch_parity import CAMERA, n, t

W, H = 32, 24
AA_KW = dict(width=W, height=H, lighting="nee", bounces=2, virtual_bounces=2,
             denoise_passes=0, enable_taa=False, differentiable=True,
             tonemap="none")                    # tests/test_antialias.py:19-25
GRAD_RTOL = 1e-4


def port_mats(camera, device="cpu"):
    jm = jcamera_matrices(JCamera(**camera), W, H)
    return convert.mats_from_numpy({k: np.asarray(v) for k, v in jm.items()},
                                   device=device)


@pytest.fixture(scope="module")
def cornell():
    js = jcornell_box()
    cfg = JConfig(width=W, height=H)
    mats = jcamera_matrices(JCamera(**CAMERA), W, H)
    orig, dirs = jgenerate_rays(mats, W, H)
    hit = jtrace_closest(jmake_tracer(js, cfg), orig.reshape(-1, 3),
                         dirs.reshape(-1, 3))
    tri = np.asarray(jnp.where(hit.hit, hit.tri, -1))
    t_hit = np.asarray(jnp.where(hit.hit, hit.t, 1e9))
    return js, port_scene_of(js), mats, tri, t_hit


def test_projection_matches_raygen(cornell):
    _, ps, _, _, _ = cornell
    cfg = RenderConfig(**AA_KW)
    mats = port_mats(CAMERA)
    orig, dirs = generate_rays(mats, W, H)
    o, d = orig.reshape(-1, 3), dirs.reshape(-1, 3)
    hit = trace_closest(make_tracer(ps, cfg), o, d)
    pos = o + d * hit.t[:, None]
    ux, uy, behind = antialias._project_unit(mats["view_proj"], pos[:, 0],
                                             pos[:, 1], pos[:, 2])
    sx, sy = ux * W, uy * H
    m = n(hit.hit)
    xs = np.tile(np.arange(W) + 0.5, H)
    ys = np.repeat(np.arange(H) + 0.5, W)
    assert m.sum() > 0.9 * W * H
    assert not n(behind)[m].any()
    np.testing.assert_allclose(n(sx)[m], xs[m], atol=5e-2)
    np.testing.assert_allclose(n(sy)[m], ys[m], atol=5e-2)


def test_pass_matches_jax_and_touches_silhouettes_only(cornell):
    js, ps, mats, tri, t_hit = cornell
    img = np.random.default_rng(0).random((H, W, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda im: jantialias.primary_edge_aa(
        js, JConfig(width=W, height=H), None, mats, im, tri=tri,
        t_hit=t_hit))(jnp.asarray(img)))
    got = n(antialias.primary_edge_aa(
        ps, RenderConfig(width=W, height=H), None, port_mats(CAMERA), t(img),
        tri=t(tri), t_hit=t(t_hit)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    changed = np.abs(got - img).max(axis=-1) > 1e-6
    assert 0 < changed.mean() < 0.35


def test_pass_traces_without_the_frames_hit(cornell):
    """tri / t_hit absent: the pass takes its own camera trace."""
    _, ps, _, tri, t_hit = cornell
    cfg = RenderConfig(width=W, height=H)
    mats = port_mats(CAMERA)
    img = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(1))
    own = antialias.primary_edge_aa(ps, cfg, make_tracer(ps, cfg), mats, img)
    given = antialias.primary_edge_aa(ps, cfg, None, mats, img, tri=t(tri),
                                      t_hit=t(t_hit))
    assert torch.equal(own, given)
    with pytest.raises(ValueError):
        antialias.primary_edge_aa(ps, cfg, None, mats, img, tri=t(tri))


def _occluder_scene():
    """tests/test_antialias.py:79-112: emissive wall behind an emissive
    occluder, zero albedo. Returns (JAX scene, occluder vertex ids)."""
    from sunray_tpu.scene.manager import SceneManager
    from sunray_tpu.scene.types import translate

    def quad(w_, h_):
        p = np.asarray(
            [[-w_ / 2, -h_ / 2, 0], [w_ / 2, -h_ / 2, 0],
             [w_ / 2, h_ / 2, 0], [-w_ / 2, h_ / 2, 0]], np.float32)
        nrm = np.tile(np.asarray([[0, 0, 1.0]], np.float32), (4, 1))
        return p, nrm, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)

    mgr = SceneManager()
    mgr.add_mesh("wall", *quad(8.0, 6.0),
                 {"base_color": (0, 0, 0, 1),
                  "emissive_factor": (1.0, 1.0, 1.0, 0.8)})
    mgr.add_mesh("occ", *quad(2.4, 4.0),
                 {"base_color": (0, 0, 0, 1),
                  "emissive_factor": (1.0, 1.0, 1.0, 0.15)})
    sc = mgr.build([("wall", translate(0, 0, -1.0)),
                    ("occ", translate(-1.1, 0, 1.0))], pad_to_capacity=False)
    vidx = np.asarray(sc.tri_vidx)[np.asarray(sc.tri_inst) == 1].ravel()
    return sc, np.unique(vidx)


OCC_CAMERA = dict(position=(0.0, 0.0, 4.0), target=(0.0, 0.0, 0.0),
                  fov_y=45.0)


@pytest.fixture(scope="module")
def occluder():
    return _occluder_scene()


def _jax_grads(jsc, vsel, aa):
    cfg = JConfig(**dict(AA_KW, edge_antialias=aa))

    def loss_dx(dx):
        sc = jsc.replace(positions=jnp.asarray(jsc.positions)
                         .at[vsel, 0].add(dx))
        mats = jcamera_matrices(JCamera(**OCC_CAMERA), W, H)
        _, ldr, _ = jrender_frame(sc, cfg, JState.create(cfg), mats)
        return jnp.mean(ldr)

    def loss_px(px):
        cam = JCamera(position=(px, 0.0, 4.0), target=(0.0, 0.0, 0.0),
                      fov_y=45.0)
        mats = jcamera_matrices(cam, W, H)
        _, ldr, _ = jrender_frame(jsc, cfg, JState.create(cfg), mats)
        return jnp.mean(ldr)

    return (float(jax.jit(jax.grad(loss_dx))(0.0)),
            float(jax.jit(jax.grad(loss_px))(0.0)))


def _port_grads(jsc, vsel, aa):
    cfg = RenderConfig(**dict(AA_KW, edge_antialias=aa))
    ps = port_scene_of(jsc)
    sel = torch.zeros_like(ps.positions)
    sel[torch.from_numpy(vsel).long(), 0] = 1.0
    dx = torch.zeros((), requires_grad=True)
    sc = dataclasses.replace(ps, positions=ps.positions + dx * sel)
    mats = camera_matrices(Camera(**OCC_CAMERA), W, H, device="cpu")
    _, ldr, _ = render_frame(sc, cfg, RenderState.create(cfg, "cpu"), mats)
    g_dx, = torch.autograd.grad(ldr.mean(), dx)
    eye = torch.tensor((0.0, 0.0, 4.0), requires_grad=True)
    mats = camera_matrices(Camera(position=eye, target=(0.0, 0.0, 0.0),
                                  fov_y=45.0), W, H, device="cpu")
    _, ldr, _ = render_frame(ps, cfg, RenderState.create(cfg, "cpu"), mats)
    g_eye, = torch.autograd.grad(ldr.mean(), eye)
    return float(g_dx), float(g_eye[0])


def test_no_gradient_through_silhouettes_without_antialias(occluder):
    g_dx, _ = _port_grads(*occluder, aa=False)
    assert abs(g_dx) < 1e-6


def test_silhouette_gradients_match_jax(occluder):
    want = _jax_grads(*occluder, aa=True)
    got = _port_grads(*occluder, aa=True)
    assert got[0] < 0 and got[1] > 0       # the reference's signs
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL)
