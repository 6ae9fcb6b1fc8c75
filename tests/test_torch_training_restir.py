"""PyTorch port, parallel/sharding.training_step on the default ReSTIR
config (TAA on, 4 a-trous passes, DI radius 30, GI 20,
differentiable=True) at 32x64 with two views, on 4 gloo ranks
(tests/torch_dist.py) at (dp, sp) = (2, 2) and (1, 4), against the
function JAX's training_step differentiates
(tests/torch_train_cases.jax_step: jax.value_and_grad of the mean
squared error over render_frame from RenderState.create). At sp = 4 the
16-row bands are below halo_s = 31, so the spatial-reuse halos take two
hops, forward and backward. Bars: the loss within 1e-5 relative; the
gradient w.r.t. base_color within torch_grad_cases.assert_grads_close's
bars, and within 1e-5 of the largest entry of the port's own
single-device step; the same bits on every rank and on two runs. The
JAX compile (~130 s) and the port's single-device step run while the
ranks render."""

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

KW = dict(width=32, height=64, differentiable=True)
SHAPES = ((2, 2), (1, 4))
RUNS = 2


@pytest.fixture(scope="module")
def steps():
    case = train_case(KW)
    got, (ref, single) = run_ranks(
        4, train_meshes, case, SHAPES, RUNS,
        meanwhile=lambda: (jax_step(case), single_step(case)))
    return {shape: [r[i] for r in got] for i, shape in enumerate(SHAPES)}, \
        ref, single


def test_four_shards_take_two_hops():
    """hl = 16 at sp = 4 against halo_s = max(DI 30, GI 20) + 1."""
    from sunray_tpu_torch.config import RenderConfig

    cfg = RenderConfig(**KW)
    halo_s = int(max(cfg.di_spatial_radius, cfg.gi_spatial_radius)) + 1
    assert KW["height"] // 4 < halo_s <= KW["height"] - KW["height"] // 4
    assert cfg.lighting == "restir" and cfg.enable_taa
    assert cfg.denoise_passes == 4


@pytest.mark.parametrize("shape", SHAPES)
def test_loss_matches_jax(steps, shape):
    got, (loss, _), _ = steps
    for rank in got[shape]:
        for run in rank:
            np.testing.assert_allclose(float(run[0]), loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_jax(steps, shape):
    got, (_, grad), _ = steps
    assert np.abs(grad).max() > 0
    assert_grads_close(got[shape][0][0][1], grad, f"base_color {shape}")


@pytest.mark.parametrize("shape", SHAPES)
def test_gradient_matches_single_device(steps, shape):
    got, _, (loss, grad) = steps
    np.testing.assert_allclose(float(got[shape][0][0][0]), loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[shape][0][0][1], grad, rtol=0,
                               atol=SHARD_RTOL * np.abs(grad).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_same_bits_on_every_rank_and_run(steps, shape):
    got, _, _ = steps
    first = got[shape][0][0]
    for rank in got[shape]:
        for loss, grad, _ in rank:
            assert loss.tobytes() == first[0].tobytes()
            assert grad.tobytes() == first[1].tobytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_traffic(steps, shape):
    """Every rank counts the same hops, forward and backward (the JAX
    tally's count), and the backward moves fewer bytes than the forward:
    only the columns that carry a gradient go back."""
    got, _, _ = steps
    tallies = [run[2] for rank in got[shape] for run in rank]
    t = tallies[0]
    assert all(x["bytes"] == t["bytes"] and x["grad_bytes"] == t["grad_bytes"]
               for x in tallies)
    assert 0 < t["grad_bytes"] < t["bytes"]
    assert 0 < t["grad_calls"] <= t["calls"]
