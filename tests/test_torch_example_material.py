"""PyTorch port, examples/torch_optimize_material.py against the JAX
examples/optimize_material.py on the CPU at 24x18 (the example's config
otherwise: NEE, 3 bounces, 2 virtual bounces, 1 a-trous pass, TAA off,
differentiable).

(a) The loss and its gradient w.r.t. the learned base colors at the gray
start against jax.jit(jax.value_and_grad) of the loss that
optimize_material.py:49-70 builds: loss within 1e-5 relative, gradient
within rtol 1e-4 and a floor of 1e-6 of its largest entry (the bars of
test_torch_grads.py). (b) The update, torch.optim.Adam plus the clamp,
on one seeded gradient sequence, within 1e-6 relative of Adam computed in
float64 and of optax.adam plus jnp.clip within the float32 rounding of
optax's bias correction: no frame. (c) run(steps=3) against JAX's loop: each loss
within the loss bar, the parameters after each step within 1e-5. The
first Adam step moves each parameter by about lr * sign(g), so (a)'s bar
decides (c): masked entries are exactly zero on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples import torch_optimize_material as ex
from torch_parity import n

SIZE = (24, 18)
STEPS = 3
LR = 0.6 * 0.05        # optimize_material.py:72, the default --lr
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = 1e-5


def jax_loop(steps):
    """optimize_material.py:41-81 at SIZE: [(loss, gradient, params after
    the step)] for `steps` steps, as numpy."""
    from sunray_tpu.camera import Camera, camera_matrices
    from sunray_tpu.config import RenderConfig
    from sunray_tpu.render.pipeline import RenderState, render_frame
    from sunray_tpu.scene import cornell_box

    w, h = SIZE
    cfg = RenderConfig(
        width=w, height=h, lighting="nee", bounces=3, virtual_bounces=2,
        denoise_passes=1, enable_taa=False, differentiable=True,
    )
    scene = cornell_box()
    cam = Camera(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
    mats = camera_matrices(cam, cfg.width, cfg.height)

    def render(base_color):
        sc = scene.replace(
            materials=scene.materials.replace(base_color=base_color))
        _, ldr, _ = render_frame(sc, cfg, RenderState.create(cfg), mats)
        return ldr

    target = jax.jit(render)(scene.materials.base_color)
    bc_true = np.asarray(scene.materials.base_color)
    init = bc_true.copy()
    init[:3, :3] = 0.5
    learn_mask = np.zeros_like(bc_true)
    learn_mask[:3, :3] = 1.0

    def loss_fn(p):
        bc = jnp.asarray(bc_true) * (1 - learn_mask) + p * learn_mask
        return jnp.mean((render(bc) - target) ** 2)

    opt = optax.adam(LR)
    params = jnp.asarray(init)
    state = opt.init(params)
    vg = jax.jit(jax.value_and_grad(loss_fn))
    out = []
    for _ in range(steps):
        loss, g = vg(params)
        updates, state = opt.update(g, state)
        params = jnp.clip(optax.apply_updates(params, updates), 0.0, 1.0)
        out.append((float(loss), np.asarray(g), np.asarray(params)))
    return init, out


@pytest.fixture(scope="module")
def jax_run():
    return jax_loop(STEPS)


@pytest.fixture(scope="module")
def port_start():
    pb = ex.problem(SIZE, device="cpu")
    p = pb.init.clone().requires_grad_()
    loss = pb.loss(p)
    grad, = torch.autograd.grad(loss, p)
    return pb, float(loss.detach()), n(grad)


def test_start_matches_jax(jax_run, port_start):
    init, _ = jax_run
    pb, _, _ = port_start
    np.testing.assert_array_equal(n(pb.init), init)
    np.testing.assert_array_equal(n(pb.mask)[:3, :3], 1.0)
    assert n(pb.mask).sum() == 9


def test_loss_matches_jax(jax_run, port_start):
    _, steps = jax_run
    _, loss, _ = port_start
    np.testing.assert_allclose(loss, steps[0][0], rtol=LOSS_RTOL)


def test_gradient_matches_jax(jax_run, port_start):
    _, steps = jax_run
    _, _, grad = port_start
    want = steps[0][1]
    assert np.isfinite(grad).all()
    np.testing.assert_array_equal(grad[:, 3], 0.0)      # masked: exact 0
    np.testing.assert_array_equal(grad[3], 0.0)
    assert np.abs(want[:3, :3]).min() > 1e-4     # every learned entry moves
    np.testing.assert_allclose(grad, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(want).max())


def test_adam_and_clip_match_optax():
    """Ten steps of the port's update on seeded gradients, from a start
    where the clip binds on both sides: within 1e-6 relative of Adam and
    the clip computed in float64, and of optax.adam plus jnp.clip within
    1e-6 relative plus 1e-5 of the summed |update|. optax rounds its bias
    correction 1 - b2 ** t with b2 in float32 (1 - float32(0.999) is
    1.3e-5 below 0.001) but its second moment with (1 - b2) = 0.001, so
    each of its updates is ~6.4e-6 larger than Adam's; torch.optim.Adam
    takes its bias corrections in float64."""
    rng = np.random.default_rng(23)
    start = rng.uniform(0.0, 1.0, (4, 4)).astype(np.float32)
    start[0, :2] = (0.0, 1.0)
    grads = [(rng.standard_normal((4, 4)) * 10.0 ** rng.uniform(-4, -1)
              ).astype(np.float32) for _ in range(10)]
    opt = optax.adam(LR)
    jp = jnp.asarray(start)
    state = opt.init(jp)
    params = torch.from_numpy(start.copy()).requires_grad_()
    topt = ex.optimizer(params, LR)
    x = start.astype(np.float64)
    m = np.zeros_like(x)
    v = np.zeros_like(x)
    drift = np.zeros_like(x)
    clipped = 0
    for step, g in enumerate(grads, 1):
        upd, state = opt.update(jnp.asarray(g), state)
        jp = jnp.clip(optax.apply_updates(jp, upd), 0.0, 1.0)
        drift += np.abs(np.asarray(upd, np.float64))
        g64 = g.astype(np.float64)
        m = 0.9 * m + 0.1 * g64
        v = 0.999 * v + 0.001 * g64 ** 2
        x = np.clip(x - LR * (m / (1 - 0.9 ** step))
                    / (np.sqrt(v / (1 - 0.999 ** step)) + 1e-8), 0.0, 1.0)
        ex.apply_step(topt, params, torch.from_numpy(g))
        got = n(params).astype(np.float64)
        want = np.asarray(jp, np.float64)
        clipped += int(((x == 0.0) | (x == 1.0)).sum())
        np.testing.assert_allclose(got, x, rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")
        assert (np.abs(got - want) <= 1e-6 * np.abs(want) + 1e-5 * drift
                ).all(), f"step {step}"
    assert clipped > 0


def test_loop_matches_jax(jax_run, port_start):
    _, steps = jax_run
    pb, _, _ = port_start
    got = ex.run(steps=STEPS, size=SIZE, device="cpu")
    assert len(got["losses"]) == len(got["params"]) == STEPS
    for i, (loss, _, params) in enumerate(steps):
        np.testing.assert_allclose(got["losses"][i], loss, rtol=LOSS_RTOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got["params"][i], params, rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"step {i}")
    assert got["losses"][-1] < got["losses"][0]
    err = np.abs((got["params"][-1] - n(pb.bc_true))[:3, :3]).max()
    assert got["albedo_err"][-1] == pytest.approx(err)
