"""Shared cases of the sharded training-step tests
(tests/test_torch_training_restir.py, _visibility.py).

The JAX side is the function that JAX's training_step
(sunray_tpu/parallel/sharding.py:91-136) differentiates: the mean
squared error of render_frame from RenderState.create over the views
against the targets, its value and gradient w.r.t. base_color by one
jax.jit of jax.value_and_grad. GSPMD only splits that function over a
mesh (tests/test_torch_training_step.py holds the mesh path at NEE).
The port and JAX get the same scene, views and seeded targets as numpy.

The views are batched by jax.vmap, as training_step batches them, or
(vmap=False) each view's share of the loss is one call of a single
compile of one view, the views' values and gradients summed. At the
visibility test's config (2 bounces, TAA off, no denoise) the vmapped
compile moves the white material's base_color gradient by 4-5% (the row
alone, (+0.00077, +0.00077, +0.0020) on ~0.02-0.04), where a compile of
the views in turn, or of one view, agrees with the port's single-device
step to 2e-7: the exact white tie of tests/test_torch_grads_tie.py,
rounded apart by the batched compile. The one-view compile costs a third
of the two-view one there (~30 s against ~90).
"""

import jax
import jax.numpy as jnp
import numpy as np

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu.render.pipeline import render_frame as jrender_frame
from sunray_tpu.scene import cornell_box as jcornell_box
from torch_parity import to_numpy

VIEWS = 2
LOSS_RTOL = 1e-5
SHARD_RTOL = 1e-5     # sharded vs the port's single-device gradient, of
                      # its largest |entry|


def jax_scene(topology):
    scene = jcornell_box()
    if topology:
        from sunray_tpu.render import boundary

        scene = boundary.with_edge_topology(scene)
    return scene


def train_case(kw, topology=False, seed=21):
    """The step's inputs as numpy: the Cornell box (with its edge
    topology when `topology`), VIEWS views (tests/test_torch_training_
    step.py's cameras) and seeded targets."""
    w, h = kw["width"], kw["height"]
    cams = [JCamera(position=(1.0, 1.0, 3.2 + 0.1 * i),
                    target=(1.0, 1.0, 0.0), fov_y=45.0)
            for i in range(VIEWS)]
    mats = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[jcamera_matrices(c, w, h) for c in cams])
    rng = np.random.default_rng(seed)
    targets = rng.uniform(0.0, 1.0, (VIEWS, h, w, 3)).astype(np.float32)
    return dict(kw=kw, topology=topology,
                scene=to_numpy(jax_scene(topology)), mats=mats,
                targets=targets)


def jax_step(case, vmap=True):
    """(loss, gradient w.r.t. base_color) of JAX's training_step function
    on case, as numpy; vmap=False sums one compiled view's calls."""
    cfg = JConfig(**case["kw"])
    scene = jax_scene(case["topology"])
    mats = {k: jnp.asarray(v) for k, v in case["mats"].items()}
    targets = jnp.asarray(case["targets"])

    def render(param, m):
        sc = scene.replace(materials=scene.materials.replace(
            base_color=param))
        _, ldr, _ = jrender_frame(sc, cfg, JState.create(cfg), m)
        return ldr

    param = scene.materials.base_color
    if vmap:
        loss, grad = jax.jit(jax.value_and_grad(lambda p: jnp.mean(
            (jax.vmap(lambda m: render(p, m))(mats) - targets) ** 2)))(param)
        return float(loss), np.asarray(grad)
    one = jax.jit(jax.value_and_grad(
        lambda p, m, t: jnp.sum((render(p, m) - t) ** 2) / targets.size))
    loss, grad = 0.0, 0.0
    for i in range(VIEWS):
        v, g = one(param, {k: x[i] for k, x in mats.items()}, targets[i])
        loss, grad = loss + float(v), grad + np.asarray(g)
    return loss, grad
