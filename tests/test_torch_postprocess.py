"""PyTorch port, K7 and the post pipeline: the plain a-trous passes against
the jnp reference postprocess.atrous_denoise(kernel="jnp") (which
tests/test_pallas_image.py holds equal to the Pallas kernel) within 1e-5,
temporal_accumulate and tonemap within 1e-6. The CUDA a-trous kernel is
held to the plain version in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.render import postprocess as jpost
from sunray_tpu_torch.render import postprocess as ppost
from torch_parity import n, t


def _guides(h, w, seed):
    """G-buffer-like guides: a sky band, smooth (bypassed) patches, flat
    walls with a few normal breaks, albedos with exact zeros."""
    rng = np.random.default_rng(seed)
    color = (rng.uniform(size=(h, w, 3)) * 2.0).astype(np.float32)
    depth = (1.0 + 3.0 * rng.uniform(size=(h, w))).astype(np.float32)
    depth[: h // 8] = 100000.0
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    normal[:, w // 2:] = (0.0, 1.0, 0.0)
    normal += rng.normal(size=normal.shape).astype(np.float32) * 0.05
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    rough = rng.uniform(size=(h, w)).astype(np.float32)
    diffuse = rng.uniform(size=(h, w, 3)).astype(np.float32)
    diffuse[::7, ::5] = 0.0
    return color, depth, normal, rough, diffuse


@pytest.mark.parametrize("passes", [2, 4])
@pytest.mark.parametrize("size", [(48, 64), (37, 53)])
def test_atrous_matches_reference(passes, size):
    args = _guides(*size, seed=passes)
    want = jpost.atrous_denoise(*(jnp.asarray(a) for a in args), passes,
                                kernel="jnp")
    got = ppost.atrous_denoise(*(t(a) for a in args), passes)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    # The bypass passes color through untouched.
    sky = args[1] >= 10000.0
    np.testing.assert_array_equal(n(got)[sky], args[0][sky])


def test_atrous_pass_matches_reference():
    args = _guides(40, 56, seed=9)
    for step in (1, 2, 4, 8):
        want = jpost.atrous_denoise_pass(*(jnp.asarray(a) for a in args), step)
        got = ppost.atrous_denoise_pass(*(t(a) for a in args), step)
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("frame_count", [0, 5])
def test_temporal_accumulate_matches_reference(frame_count):
    rng = np.random.default_rng(frame_count)
    h, w = 48, 64
    raw = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    hist = (rng.uniform(size=(h, w, 3)) * 3.0).astype(np.float32)
    motion = (rng.normal(size=(h, w, 2)) * 0.02).astype(np.float32)
    motion[:4] = 2.5   # off-screen history
    # Under jit, as the frame runs it: XLA turns the division of the pixel
    # centres by the image size into a multiply by its reciprocal, and so
    # does the port (camera.pixel_centers).
    want = jax.jit(jpost.temporal_accumulate)(
        jnp.asarray(raw), jnp.asarray(motion), jnp.asarray(hist),
        jnp.int32(frame_count))
    got = ppost.temporal_accumulate(t(raw), t(motion), t(hist),
                                    torch.tensor(frame_count, dtype=torch.int32))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)
    if frame_count <= 2:
        np.testing.assert_array_equal(n(got), raw)


@pytest.mark.parametrize("mode", ["aces", "aces_srgb", "none"])
def test_tonemap_matches_reference(mode):
    rng = np.random.default_rng(4)
    x = (rng.uniform(size=(32, 40, 3)) * 4.0).astype(np.float32)
    x[0, 0, 1] = np.nan
    x[1, 1, 0] = np.inf
    x[2, 2] = 0.0
    want = jpost.tonemap(jnp.asarray(x), 1.3, mode, 2.2)
    got = ppost.tonemap(t(x), 1.3, mode, 2.2)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6)
    assert np.isfinite(n(got)).all()

