"""PyTorch port, utils/jpeg.py on progressive JPEG (SOF2): PIL's
progressive=True streams (libjpeg-turbo's default scan script: DC first
and refinement scans, spectral bands with successive approximation, end-
of-band runs) decode bit-equal to PIL's decode at quality 25, 75 and 95,
subsampling 0, 1 and 2 (4:4:4, 4:2:2, 4:2:0), sizes 1x1, 17x9 and 37x23,
with and without restart intervals, and grey; the committed file
tests/data/progressive_96x64.jpg decodes to the pixels whose SHA-256
chip_smoke.py phase 14 checks on the card's machine (no PIL there);
load_gltf takes a progressive JPEG texture as the JAX package does; a
truncated or corrupt progressive stream raises ValueError."""

import base64
import hashlib
import io
import os

import numpy as np
import pytest
from PIL import Image

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu.scene.gltf import load_gltf as jload_gltf
from sunray_tpu_torch.scene.gltf import load_gltf
from sunray_tpu_torch.utils.jpeg import read_jpeg, read_jpeg_rgba
from test_torch_gltf import _write_gltf, assert_scene_equal
from test_torch_jpeg import assert_pil_equal, pil_jpeg, seeded_image
from tools.synth_gltf import build_document

TESTS = os.path.dirname(os.path.abspath(__file__))
COMMITTED = os.path.join(TESTS, "data", "progressive_96x64.jpg")
COMMITTED_SHA256 = (          # PIL's RGB pixels; chip_smoke.PROGRESSIVE_SHA256
    "1c4458e1f301711493fa4722898932ae39c643d1cff790214bb17c552bd66458")
SIZES = [(1, 1), (9, 17), (23, 37)]                  # (height, width)


@pytest.mark.parametrize("restart", [0, 2], ids=["no_rst", "rst2"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [25, 75, 95])
def test_pil_progressive(quality, subsampling, size, restart):
    kw = dict(quality=quality, subsampling=subsampling, progressive=True)
    if restart:
        kw["restart_marker_blocks"] = restart
    data = pil_jpeg(seeded_image(*size, seed=quality + 3 * subsampling), **kw)
    assert b"\xff\xc2" in data
    assert (b"\xff\xdd" in data) == bool(restart)
    assert_pil_equal(data)


@pytest.mark.parametrize("size", [(9, 17), (64, 96)], ids=["17x9", "96x64"])
def test_pil_progressive_grey_and_optimised(size):
    assert_pil_equal(pil_jpeg(seeded_image(*size, seed=4, channels=1),
                              quality=80, progressive=True))
    assert_pil_equal(pil_jpeg(seeded_image(*size, seed=5), quality=90,
                              progressive=True, optimize=True,
                              restart_marker_rows=1))


def test_committed_file():
    with open(COMMITTED, "rb") as f:
        data = f.read()
    assert b"\xff\xc2" in data and b"\xff\xdd" in data
    px = read_jpeg(COMMITTED)
    np.testing.assert_array_equal(px, np.asarray(Image.open(COMMITTED)
                                                 .convert("RGB")))
    assert hashlib.sha256(px.tobytes()).hexdigest() == COMMITTED_SHA256


def test_gltf_takes_progressive_texture(tmp_path):
    doc, data = build_document(seed=2, tex=8, subdiv=0, spheres=2)
    buf = io.BytesIO()
    Image.fromarray(seeded_image(8, 8, seed=6)).save(buf, format="JPEG",
                                                     progressive=True)
    doc["images"][3] = {"uri": "data:image/jpeg;base64,"
                        + base64.b64encode(buf.getvalue()).decode()}
    path = _write_gltf(tmp_path / "progressive.gltf", doc, data)
    assert_scene_equal(jload_gltf(path), load_gltf(path, device="cpu"))


PROG = pil_jpeg(seeded_image(40, 56, seed=7), quality=85, progressive=True)


@pytest.mark.parametrize("cut", [200, 600, -300, -60, -2])
def test_truncated_raises(cut):
    with pytest.raises(ValueError):
        read_jpeg_rgba(PROG[:cut])


def test_corrupt_scan_header_raises():
    """A spectral band past 63, and an AC band over two components: bad
    progressions, refused as libjpeg refuses them."""
    sos = PROG.index(b"\xff\xda")
    sos = PROG.index(b"\xff\xda", sos + 2)         # the first AC scan
    ns = PROG[sos + 4]
    assert ns == 1
    bad = bytearray(PROG)
    bad[sos + 5 + 2 * ns + 1] = 64                  # Se
    with pytest.raises(ValueError, match="progression"):
        read_jpeg_rgba(bytes(bad))
    first = PROG.index(b"\xff\xda")                 # DC scan, 3 components
    bad = bytearray(PROG)
    bad[first + 5 + 2 * PROG[first + 4]] = 1        # Ss 1 with 3 components
    with pytest.raises(ValueError, match="progression"):
        read_jpeg_rgba(bytes(bad))
