"""PyTorch port, parallel/sharding.training_step with edge antialiasing
and the ReSTIR shadow-boundary term (the Cornell box with its edge
topology, top-8 candidates; ReSTIR, 2 bounces, TAA off, no denoise) at
32x64 with two views, on 2 gloo ranks (tests/torch_dist.py) at (dp, sp)
= (2, 1) and (1, 2), against the function JAX's training_step
differentiates (tests/torch_train_cases.jax_step, one view's compile
called for each view: the vmapped compile rounds the white tie apart at
this config), whose
render_frame runs both passes. At (1, 2) the edge-antialiasing pairs
across the band edge read the 1-row halo. Bars: loss within 1e-5
relative, the gradient w.r.t. base_color within
torch_grad_cases.assert_grads_close's bars and within 1e-5 of the
largest entry of the port's own single-device step, the same bits on
every rank. The JAX compile runs while the ranks render.

The shadow-boundary term is zero forward and its coefficients are
constants of the backward, so it moves no material gradient: it shows in
the gradient w.r.t. the vertex positions, which the last case holds on
training_step's grid (one band, in this process) to render_frame's,
itself held to JAX's by tests/test_torch_boundary_frame_restir.py."""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread in this process)
from torch_dist import run_ranks, single_step, train_meshes
from torch_grad_cases import assert_grads_close
from torch_train_cases import (
    LOSS_RTOL,
    SHARD_RTOL,
    jax_step,
    train_case,
)

KW = dict(width=32, height=64, bounces=2, virtual_bounces=2,
          denoise_passes=0, enable_taa=False, differentiable=True,
          edge_antialias=True, shadow_boundary_grads=True,
          shadow_boundary_candidates=8)
SHAPES = ((2, 1), (1, 2))


@pytest.fixture(scope="module")
def steps():
    case = train_case(KW, topology=True)
    got, (ref, single) = run_ranks(
        2, train_meshes, case, SHAPES,
        meanwhile=lambda: (jax_step(case, vmap=False), single_step(case)))
    return {shape: [r[i][0] for r in got] for i, shape in
            enumerate(SHAPES)}, ref, single


@pytest.mark.parametrize("shape", SHAPES)
def test_loss_matches_jax(steps, shape):
    got, (loss, _), _ = steps
    for run in got[shape]:
        np.testing.assert_allclose(float(run[0]), loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax(steps, shape):
    got, (_, grad), _ = steps
    assert np.abs(grad).max() > 0
    assert_grads_close(got[shape][0][1], grad, f"base_color {shape}")


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_single_device(steps, shape):
    got, _, (_, grad) = steps
    np.testing.assert_allclose(got[shape][0][1], grad, rtol=0,
                               atol=SHARD_RTOL * np.abs(grad).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_same_bits_on_every_rank(steps, shape):
    got, _, _ = steps
    for loss, grad, _ in got[shape]:
        assert loss.tobytes() == got[shape][0][0].tobytes()
        assert grad.tobytes() == got[shape][0][1].tobytes()


def test_halo_traffic(steps):
    """(2, 1) moves nothing; at (1, 2) the forward and the backward each
    take their hops."""
    got, _, _ = steps
    assert got[(2, 1)][0][2]["bytes"] == 0
    t = got[(1, 2)][0][2]
    assert t["sent_bytes"] > 0 and t["grad_sent_bytes"] > 0


def test_boundary_term_on_the_training_grid():
    """The positions gradient of one view's frame on training_step's grid
    (ShardGrid.whole_frame) matches render_frame's within 1e-6 of its
    largest entry; the spmd frame's grid, which leaves the term out, is
    off by more than 1e-4."""
    import dataclasses

    import torch

    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.halo import make_grid
    from sunray_tpu_torch.parallel.spmd import _frame_local, shard_state
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from torch_dist import train_scene

    case = train_case(KW, topology=True)
    cfg = RenderConfig(**KW)
    mats = {k: torch.from_numpy(v[0]) for k, v in case["mats"].items()}

    def positions_grad(render):
        scene = train_scene(case)
        pos = scene.positions.clone().requires_grad_(True)
        ldr = render(dataclasses.replace(scene, positions=pos))
        return torch.autograd.grad(ldr.mean(), pos)[0].numpy()

    ref = positions_grad(lambda sc: render_frame(
        sc, cfg, RenderState.create(cfg, "cpu"), mats)[1])
    scale = np.abs(ref).max()
    for whole_frame in (True, False):
        grid = dataclasses.replace(make_grid(cfg), whole_frame=whole_frame)
        got = positions_grad(lambda sc: _frame_local(
            sc, cfg, shard_state(RenderState.create(cfg, "cpu"), cfg, grid),
            mats, grid)[1])
        err = np.abs(got - ref).max()
        if whole_frame:
            assert err <= 1e-6 * scale
        else:
            assert err > 1e-4 * scale
