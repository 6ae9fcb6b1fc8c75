"""PyTorch port, utils/jpeg.write_jpeg (native/jpeg_encoder.cpp) against
PIL 12.1.0's libjpeg-turbo: the stream must be byte-equal to
Image.fromarray(u8).save(buf, "JPEG", quality=q) at quality 25, 50, 85,
95 and 100 and sizes 1x1, 17x9, 37x23, 48x32, 96x64 and 480x270, on
seeded images and on a frame the port renders (the live viewer's u8
conversion of a 48x32 NEE frame, with its stats overlay); and the port's
own decoder (utils/jpeg.read_jpeg) reads it back as PIL does."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu_torch.camera import Camera
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.integrations.viewer import frame_u8
from sunray_tpu_torch.render.overlay import stats_overlay
from sunray_tpu_torch.render.renderer import Renderer
from sunray_tpu_torch.scene import cornell_box
from sunray_tpu_torch.utils import jpeg
from sunray_tpu_torch.utils.jpeg import read_jpeg, write_jpeg
from test_torch_jpeg import seeded_image
from torch_parity import CAMERA

QUALITIES = [25, 50, 85, 95, 100]
SIZES = [(1, 1), (9, 17), (23, 37), (32, 48), (64, 96), (270, 480)]  # (h, w)


def pil_bytes(u8, quality):
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def assert_same_stream(u8, quality):
    got, want = write_jpeg(u8, quality), pil_bytes(u8, quality)
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
        pytest.fail(f"{len(got)} vs {len(want)} bytes, first difference at "
                    f"byte {first}")
    np.testing.assert_array_equal(
        read_jpeg(got), np.asarray(Image.open(io.BytesIO(want)).convert("RGB")))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_seeded_image_byte_equal(quality, size):
    assert_same_stream(seeded_image(*size, seed=quality + size[0]), quality)


@pytest.mark.parametrize("kind", ["flat", "noise", "extremes"])
def test_edge_content_byte_equal(kind):
    """Flat colour (all AC zero), full-range noise and alternating 0/255
    (the largest coefficients and DC steps) at an odd size."""
    g = np.random.default_rng(3)
    h, w = 37, 53
    if kind == "flat":
        u8 = np.broadcast_to(np.array([200, 30, 90], np.uint8), (h, w, 3))
    elif kind == "noise":
        u8 = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
    else:
        u8 = np.where((np.add.outer(np.arange(h), np.arange(w)) % 2)[..., None],
                      255, 0).astype(np.uint8).repeat(3, axis=2)
    for q in (25, 100):
        assert_same_stream(np.ascontiguousarray(u8), q)


@pytest.fixture(scope="module")
def rendered_u8():
    cfg = RenderConfig(width=48, height=32, lighting="nee", denoise_passes=0)
    r = Renderer(cfg, scene=cornell_box(device="cpu"), device="cpu")
    ldr = None
    for _ in range(2):
        ldr = r.render(Camera(**CAMERA))
    return frame_u8(stats_overlay(ldr, ["FPS 12.50", "FRAME 00002"]))


@pytest.mark.parametrize("quality", QUALITIES)
def test_rendered_frame_byte_equal(rendered_u8, quality):
    assert rendered_u8.shape == (32, 48, 3) and rendered_u8.dtype == np.uint8
    assert_same_stream(rendered_u8, quality)


def test_tables_and_refusals():
    luma, chroma = jpeg.quality_tables(50)
    np.testing.assert_array_equal(luma, jpeg.STD_LUMA_QUANT)
    np.testing.assert_array_equal(chroma, jpeg.STD_CHROMA_QUANT)
    assert (jpeg.quality_tables(100)[0] == 1).all()
    assert jpeg.quality_tables(1)[0].max() == 255        # force_baseline
    with pytest.raises(ValueError):
        write_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        write_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError):
        write_jpeg(np.zeros((0, 4, 3), np.uint8))
    torch_u8 = torch.zeros((4, 4, 3), dtype=torch.uint8)
    assert write_jpeg(torch_u8.numpy(), 85) == pil_bytes(torch_u8.numpy(), 85)
