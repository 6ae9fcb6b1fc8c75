"""Shared cases of the differentiable-frame tests (tests/test_torch_grads*.py).

The frame of tests/test_grads.py:13-20 (the Cornell box at 32x24,
bounces=2, virtual_bounces=2, tonemap="none", no TAA, no denoise,
differentiable=True), loss mean(ldr), and its gradients w.r.t. the
material table's base_color and metallic and the vertex positions. The
JAX package and the port get the same scene, as numpy arrays.

The JAX gradients come from two compiles: jax.jit of value_and_grad
w.r.t. (base_color, metallic), and jax.jit of grad w.r.t. positions. One
compile w.r.t. base_color and positions together rounds one channel of
the DI winner's f_y apart from the others: on a white surface under the
white light (an exact three-way tie in (0.73, 0.73, 0.73) x emission) it
comes out one ulp above the other two, so jnp.max's JVP sends the whole
tie gradient to that channel, and the white material's base_color
gradient moves by 2-4% (channels +a, +a, -2a). JAX without jit, and each
of these two compiles, keep the tie and split it evenly, as torch.amax
does; that split is the function's, the joint compile's is XLA's
rounding. tests/test_torch_grads_tie.py holds both readings: the joint
compile moves the white row alone, by that pattern; JAX without jit
shows no such move.
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
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from torch_parity import CAMERA, n, to_numpy

W, H = 32, 24
GRAD_KW = dict(width=W, height=H, bounces=2, virtual_bounces=2,
               denoise_passes=0, enable_taa=False, differentiable=True,
               tonemap="none")                   # tests/test_grads.py:16-20
PARAMS = ("base_color", "metallic", "positions")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6     # times the largest |gradient| of the parameter


def jax_scene(topology=False):
    """The JAX Cornell box, with its edge topology (boundary.py) when
    `topology`: the shadow-boundary term needs it."""
    scene = jcornell_box()
    if topology:
        from sunray_tpu.render import boundary

        scene = boundary.with_edge_topology(scene)
    return scene


def jax_value_and_grads(topology=False, with_positions_value=False, **kw):
    """(loss, {param: gradient}) of the JAX frame, as numpy; with
    `with_positions_value`, also the loss as the positions gradient's
    compile evaluates it (edge antialiasing rounds a few pixels apart
    there, tests/test_torch_antialias_frame.py)."""
    cfg = JConfig(**dict(GRAD_KW, **kw))
    scene = jax_scene(topology)
    mats = jcamera_matrices(JCamera(**CAMERA), W, H)

    def loss(base_color, metallic, positions):
        sc = scene.replace(
            materials=scene.materials.replace(base_color=base_color,
                                              metallic=metallic),
            positions=positions)
        _, ldr, _ = jrender_frame(sc, cfg, JState.create(cfg), mats)
        return jnp.mean(ldr)

    args = (scene.materials.base_color, scene.materials.metallic,
            scene.positions)
    value, (g_bc, g_m) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        *args)
    value_pos, g_pos = jax.jit(jax.value_and_grad(loss, argnums=2))(*args)
    grads = {k: np.asarray(g) for k, g in zip(PARAMS, (g_bc, g_m, g_pos))}
    if with_positions_value:
        return float(value), grads, float(value_pos)
    return float(value), grads


def jax_base_color_grad(jit_with_positions, **kw):
    """The JAX frame's gradient w.r.t. base_color, as numpy: from one
    jax.jit of the gradient w.r.t. (base_color, positions) together, or
    with every op run un-jitted (jax.disable_jit)."""
    cfg = JConfig(**dict(GRAD_KW, **kw))
    scene = jcornell_box()
    mats = jcamera_matrices(JCamera(**CAMERA), W, H)

    def loss(base_color, positions):
        sc = scene.replace(materials=scene.materials.replace(
            base_color=base_color), positions=positions)
        _, ldr, _ = jrender_frame(sc, cfg, JState.create(cfg), mats)
        return jnp.mean(ldr)

    args = (scene.materials.base_color, scene.positions)
    if jit_with_positions:
        return np.asarray(jax.jit(jax.grad(loss, argnums=(0, 1)))(*args)[0])
    with jax.disable_jit():
        return np.asarray(jax.grad(loss)(*args))


def port_scene(device="cpu", requires_grad=PARAMS, topology=False):
    """The JAX Cornell box in the port, with the named parameters as
    leaves that require grad, and with the port's own edge topology when
    `topology`. Returns (scene, {param: leaf})."""
    scene = convert.scene_from_numpy(to_numpy(jcornell_box()), device=device)
    if topology:
        from sunray_tpu_torch.render import boundary

        scene = boundary.with_edge_topology(scene)
    mats = scene.materials
    leaves = {"base_color": mats.base_color, "metallic": mats.metallic,
              "positions": scene.positions}
    leaves = {k: (v.clone().requires_grad_() if k in requires_grad else v)
              for k, v in leaves.items()}
    scene = dataclasses.replace(
        scene, positions=leaves["positions"],
        materials=dataclasses.replace(mats, base_color=leaves["base_color"],
                                      metallic=leaves["metallic"]))
    return scene, {k: leaves[k] for k in requires_grad}


def port_mats(device="cpu"):
    jmats = jcamera_matrices(JCamera(**CAMERA), W, H)
    return convert.mats_from_numpy({k: np.asarray(v) for k, v in
                                    jmats.items()}, device=device)


def port_value_and_grads(topology=False, **kw):
    """(loss, {param: gradient}) of the port's frame on the CPU."""
    cfg = RenderConfig(**dict(GRAD_KW, **kw))
    scene, leaves = port_scene(topology=topology)
    _, ldr, _ = render_frame(scene, cfg, RenderState.create(cfg, "cpu"),
                             port_mats())
    loss = ldr.mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: n(g) for k, g in zip(leaves, grads)}


def assert_grads_close(got, want, name):
    """Elementwise within GRAD_RTOL, with an absolute floor of GRAD_ATOL
    times the largest |want| (entries that are zero up to float dust)."""
    atol = GRAD_ATOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol,
                               err_msg=name)
