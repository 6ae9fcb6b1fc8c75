"""Shared JAX side of the pose-gradient tests of
examples/torch_optimize_camera.py (tests/test_torch_example_camera*.py):
the loss of examples/optimize_camera.py:49-80 at SIZE, its value and
gradient at the example's start pose from one jax.jit of
jax.value_and_grad, as the example's update step compiles it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

SIZE = (24, 18)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6     # atol: times the largest |gradient|


def jax_pose_value_and_grad(edge_aa=False, joint=False):
    """(loss, {"position"[, "target"]: gradient}) as numpy."""
    from sunray_tpu.camera import Camera, camera_matrices
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.render.pipeline import RenderState, render_frame
    from sunray_tpu.scene import cornell_box

    w, h = SIZE
    cfg = RenderConfig(
        width=w, height=h, lighting="nee", bounces=2, virtual_bounces=2,
        denoise_passes=1, enable_taa=False, differentiable=True,
        edge_antialias=edge_aa,
    )
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)

    def render(position, target):
        c = dataclasses.replace(cam, position=position, target=target)
        mats = camera_matrices(c, cfg.width, cfg.height)
        _, ldr, _ = render_frame(scene, cfg, RenderState.create(cfg), mats)
        return ldr

    true_pos = jnp.asarray(cam.position)
    true_tgt = jnp.asarray(cam.target)
    target_img = jax.jit(render)(true_pos, true_tgt)
    params = {"position": true_pos + jnp.asarray([0.25, -0.2, 0.3])}
    if joint:
        params["target"] = true_tgt + jnp.asarray([-0.2, 0.15, 0.0])

    def loss(p):
        img = render(p["position"], p.get("target", true_tgt))
        return jnp.mean((img - target_img) ** 2)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), {k: np.asarray(g) for k, g in grads.items()}


def assert_grad_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * float(np.abs(want).max()),
                               err_msg=name)
