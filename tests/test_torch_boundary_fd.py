"""PyTorch port, the shadow-boundary gradients against central finite
differences on the occluder-translation case of tests/test_grads.py
(TestOcclusionBoundaryMatched, :217-307, and TestRestirBoundaryMatched,
:310-393), on the port's own floating-box scene: the loss reads the raw
radiance averaged over several frames, over the floor pixels eroded by
3 (the box's screen silhouette stays out), under a translation of the
box's 24 vertices in x.

- NEE, dense term: 12 frames, eps 2e-2, rtol 0.20;
- ReSTIR, the term on its top-8 candidates: 16 frames, eps 1e-2, rtol
  0.25. A differentiable frame's state enters detached (render_frame),
  where the reference's scan carries reservoir gradients across frames.

Each case takes ~10-30 s on one CPU thread, so both run in Tier-1. The
card runs both in chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import ndimage

from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.render import boundary
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene.procedural import _MeshBuilder
from torch_boundary_cases import FLOAT_CAMERA, FLOAT_SIZE, floating_scene
from torch_parity import n

CASES = {
    "nee": (dict(lighting="nee", bounces=2, virtual_bounces=2),
            12, 2e-2, 0.20),
    "restir": (dict(lighting="restir", bounces=2, virtual_bounces=2,
                    ris_candidates=8, di_spatial_samples=2,
                    gi_spatial_samples=1, shadow_boundary_candidates=8),
               16, 1e-2, 0.25),
}


def occluder_case(name, device="cpu"):
    """(loss(dx) -> scalar tensor, dx leaf) of one case: the floating-box
    scene with its box moved by dx in x."""
    kw, frames, _, _ = CASES[name]
    w, h = FLOAT_SIZE
    cfg = RenderConfig(width=w, height=h, denoise_passes=0, enable_taa=False,
                       differentiable=True, tonemap="none",
                       shadow_boundary_grads=True, **kw)
    scene = boundary.with_edge_topology(
        floating_scene(_MeshBuilder).build(device=device))
    pos0 = scene.positions
    box = (pos0[:, 1] > 1.0) & (pos0[:, 1] < 1.4)
    assert int(box.sum()) == 24
    shift = torch.zeros_like(pos0)
    shift[box, 0] = 1.0
    mats = camera_matrices(Camera(**FLOAT_CAMERA), w, h, device=device)

    def render_k(dx):
        sc = dataclasses.replace(scene, positions=pos0 + dx * shift)
        state = RenderState.create(cfg, device)
        acc, aux = 0.0, None
        for _ in range(frames):
            state, _, aux = render_frame(sc, cfg, state, mats)
            acc = acc + aux["raw"]
        return acc / frames, aux

    with torch.no_grad():
        _, aux0 = render_k(torch.zeros((), device=device))
    floor = n(aux0["normal"])[..., 1] > 0.9
    eroded = ndimage.binary_erosion(floor, iterations=3)
    assert eroded.sum() > 300
    mask = torch.from_numpy(eroded[..., None].astype(np.float32)).to(device)

    def loss(dx):
        img, _ = render_k(dx)
        return (img * mask).sum() / mask.sum()

    return loss


@pytest.mark.parametrize("name", sorted(CASES))
def test_shadow_boundary_ad_matches_fd(name):
    _, _, eps, rtol = CASES[name]
    loss = occluder_case(name)
    dx = torch.zeros((), requires_grad=True)
    g_ad, = torch.autograd.grad(loss(dx), dx)
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))
              ) / (2 * eps)
    assert abs(fd) > 0.3, f"shadow FD signal too small: {fd}"
    np.testing.assert_allclose(float(g_ad), fd, rtol=rtol)
