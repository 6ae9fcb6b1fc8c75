"""Shared cases of the differentiable real-scene tests
(tests/test_torch_grads_gltf*.py, tests/test_torch_grads_binned.py).

The frame of tests/test_grads.py:13-20 (32x24, bounces=2,
virtual_bounces=2, tonemap="none", no TAA, no denoise,
differentiable=True; tests/torch_grad_cases.GRAD_KW), loss mean(ldr),
on two scenes:

- the small synthetic GLB of tests/torch_renderer_cases.py
  (tools/synth_gltf.write_scene(seed=0, tex=16, subdiv=1, spheres=8):
  178 vertex rows, 1,024 triangles, 16 instances, 9 materials, an
  8 x 16 x 16 atlas, alpha cutout), loaded by each package's Renderer,
  which also builds the accel ("bvh": the host SAH BVH, "auto": the
  two-level BlasSet); every table is above the 512 rows of K8's
  shared-memory backward;
- the big mesh of tests/torch_big_scene.py at subdiv 3 (1,316
  triangles) with a binned ClusterSet accel (cluster_k 32).

Gradients w.r.t. positions, materials.base_color, inst_transform and the
atlas data (textures.data), as JAX's jax.jit(jax.value_and_grad) of
render_frame(scene, cfg, state, mats, accel) gives them in one compile.

Tolerances: the loss within 1e-5 relative; each gradient's finite entries
within rtol 1e-4 plus 1e-6 of its largest finite entry (as
tests/torch_grad_cases.py), and the NaN masks equal element for element
(the reference's NaN at the glass box's back faces, ROADMAP open items).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu_torch import convert
from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from tools.synth_gltf import CAMERA as GLB_CAMERA
from tools.synth_gltf import write_scene
from torch_grad_cases import GRAD_KW
from torch_parity import CAMERA, n, to_numpy

PARAMS = ("positions", "base_color", "inst_transform", "textures")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6     # times the largest finite |gradient| of the parameter


def write_glb(tmp_path_factory):
    path = tmp_path_factory.mktemp("glb") / "grads.glb"
    return write_scene(str(path), seed=0, tex=16, subdiv=1, spheres=8)


def _jax_leaves(scene):
    return (scene.positions, scene.materials.base_color,
            scene.inst_transform, scene.textures.data)


def _jax_with(scene, pos, bc, xf, tex):
    return scene.replace(positions=pos, inst_transform=xf,
                         materials=scene.materials.replace(base_color=bc),
                         textures=scene.textures.replace(data=tex))


def _port_with(scene, leaves):
    pos, bc, xf, tex = leaves
    return dataclasses.replace(
        scene, positions=pos, inst_transform=xf,
        materials=dataclasses.replace(scene.materials, base_color=bc),
        textures=dataclasses.replace(scene.textures, data=tex))


def jax_value_and_grads(jscene, jcfg, jmats, jaccel, apart=()):
    """(loss, {param: gradient}) of the JAX frame, as numpy: one compile
    of the gradients w.r.t. every parameter, and one more for each of
    `apart` alone (a joint compile can round a tied channel apart,
    tests/torch_grad_cases.py)."""

    def loss(*leaves):
        sc = _jax_with(jscene, *leaves)
        _, ldr, _ = jrender_frame(sc, jcfg, JState.create(jcfg), jmats,
                                  jaccel)
        return jnp.mean(ldr)

    args = _jax_leaves(jscene)
    joint = tuple(i for i, k in enumerate(PARAMS) if k not in apart)
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=joint))(*args)
    out = {PARAMS[i]: np.asarray(g) for i, g in zip(joint, grads)}
    for k in apart:
        i = PARAMS.index(k)
        out[k] = np.asarray(jax.jit(jax.grad(loss, argnums=i))(*args))
    return float(value), {k: out[k] for k in PARAMS}


def port_value_and_grads(scene, cfg, mats, accel, device="cpu"):
    """(loss, {param: gradient}) of the port's frame, as numpy."""
    leaves = [x.detach().clone().requires_grad_() for x in
              (scene.positions, scene.materials.base_color,
               scene.inst_transform, scene.textures.data)]
    _, ldr, _ = render_frame(_port_with(scene, leaves), cfg,
                             RenderState.create(cfg, device), mats, accel)
    loss = ldr.mean()
    # A textureless scene's trivial atlas is never read: its gradient is 0.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {k: n(g) for k, g in zip(PARAMS, grads)}


def gltf_frames(glb, topology=False, **kw):
    """Both packages' value_and_grad on the GLB: ((JAX loss, grads),
    (port loss, grads)). The Renderers load the file and build the
    accel; their configs carry alpha_mask_tracing from the scene. With
    `topology`, each package's scene gets its edge topology (the
    shadow-boundary term reads it)."""
    from sunray_tpu.render import boundary as jboundary
    from sunray_tpu.render.renderer import Renderer as JRenderer
    from sunray_tpu_torch.render import boundary
    from sunray_tpu_torch.render.renderer import Renderer

    cfg_kw = dict(GRAD_KW, **kw)
    jr = JRenderer(JConfig(**cfg_kw))
    jr.load_gltf(glb)
    pr = Renderer(RenderConfig(**cfg_kw), device="cpu")
    pr.load_gltf(glb)
    w, h = cfg_kw["width"], cfg_kw["height"]
    jmats = jcamera_matrices(JCamera(**GLB_CAMERA), w, h)
    mats = camera_matrices(Camera(**GLB_CAMERA), w, h, device="cpu")
    jscene, scene = jr.scene, pr.scene
    if topology:
        jscene = jboundary.with_edge_topology(jscene)
        scene = boundary.with_edge_topology(scene)
    want = jax_value_and_grads(jscene, jr.config, jmats, jr._scene_accel())
    got = port_value_and_grads(scene, pr.config, mats, pr._scene_accel())
    return want, got


def binned_frames(**kw):
    """Both packages' value_and_grad on the big mesh at subdiv 3 with a
    binned ClusterSet accel (tests/test_torch_frame_binned.py's scene).
    JAX's base_color gradient is compiled alone: compiled with the
    others it rounds the white material's tied DI channel apart, a
    (+a, +a, -2a) move of that row (tests/test_torch_grads_tie.py)."""
    from sunray_tpu.ops import binned_trace as jbt
    from sunray_tpu.scene.types import MaterialTable as JMaterialTable
    from sunray_tpu.scene.types import build_scene as jbuild_scene
    from sunray_tpu_torch.ops import binned_trace
    from torch_big_scene import big_scene_args

    cfg_kw = dict(GRAD_KW, cluster_k=32, **kw)
    args = big_scene_args(3)
    jscene = jbuild_scene(**dict(args, materials=JMaterialTable.build(
        args["materials"])))
    jcfg = JConfig(**cfg_kw)
    w, h = cfg_kw["width"], cfg_kw["height"]
    jmats = jcamera_matrices(JCamera(**CAMERA), w, h)
    jaccel = jbt.build_cluster_set(
        tuple(np.asarray(v) for v in jscene.world_triangle_vertices()),
        k=jcfg.cluster_k)
    cfg = RenderConfig(**cfg_kw)
    scene = convert.scene_from_numpy(to_numpy(jscene), device="cpu")
    mats = convert.mats_from_numpy({k: np.asarray(v) for k, v in
                                    jmats.items()}, device="cpu")
    accel = binned_trace.build_cluster_set(scene.world_triangle_vertices(),
                                           k=cfg.cluster_k)
    want = jax_value_and_grads(jscene, jcfg, jmats, jaccel,
                               apart=("base_color",))
    got = port_value_and_grads(scene, cfg, mats, accel)
    return want, got


def assert_loss_close(got, want):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def assert_grads_close(got, want, name):
    """Equal NaN masks, and the finite entries within GRAD_RTOL with an
    absolute floor of GRAD_ATOL times the largest finite |want|."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=f"{name}: NaN masks")
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all(), f"{name}: inf where JAX is finite"
    top = float(np.abs(want[finite]).max()) if finite.any() else 0.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * top, err_msg=name)
