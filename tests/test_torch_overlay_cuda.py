"""PyTorch port on the card: R1 (csrc/overlay.cu, ops/cuda_overlay.py)
against its plain twin (render/overlay2d.paint_meshes_plain), bit-equal,
on the seeded stress set of tests/torch_overlay_cases.py (overlapping
triangles of both windings, degenerate ones, a textured and a clipped
mesh), with one mesh of more triangles than a chunk of the tile's cull,
on the HUD of hud_overlay and on each adversarial set (thin and
non-finite triangles, edges through pixel centres, meshes off the image,
-0.0 image words, non-finite texels, negative colours, 40 meshes); two
runs give the same bits. Skipped where there is no CUDA device. This file
imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_overlay_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.ops import cuda_build, cuda_overlay
from sunray_tpu_torch.render import overlay2d
from torch_overlay_cases import (ADVERSARIAL, HUD_LINES, adversarial_set,
                                 frame_times, seeded_image, stress_meshes)
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.gpu


def to_mesh(m, dev):
    return overlay2d.Mesh2D(
        xy=torch.from_numpy(m["xy"]).to(dev),
        uv=torch.from_numpy(m["uv"]).to(dev),
        rgba=torch.from_numpy(m["rgba"]).to(dev),
        tris=torch.from_numpy(m["tris"]).to(dev),
        tex=None if m["tex"] is None else torch.from_numpy(m["tex"]).to(dev),
        clip=m["clip"])


def assert_bits(got, want):
    a = got.cpu().numpy().view(np.int32)
    b = want.cpu().numpy().view(np.int32)
    assert (a != b).sum() == 0, f"{(a != b).sum()} words differ"


@pytest.mark.parametrize("size,n_tris", [((270, 480), 2000),
                                         ((61, 97), 3 * cuda_overlay.CHUNK + 5)])
def test_r1_matches_plain(cuda_device, size, n_tris):  # noqa: F811
    h, w = size
    meshes = [to_mesh(m, cuda_device) for m in stress_meshes(h, w, n_tris, 11)]
    assert max(int(m.tris.shape[0]) for m in meshes) > cuda_overlay.CHUNK
    img = torch.from_numpy(seeded_image(h, w, 12)).to(cuda_device)
    cuda_build.launches.clear()
    got = overlay2d.paint_meshes(img, meshes)
    assert cuda_build.launches["paint_meshes"] == 1
    assert_bits(got, overlay2d.paint_meshes_plain(img, meshes))
    assert_bits(overlay2d.paint_meshes(img, meshes), got)       # same bits


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_r1_adversarial_matches_plain(cuda_device, name):  # noqa: F811
    img, meshes = adversarial_set(name, 270, 480, 21)
    img = torch.from_numpy(img).to(cuda_device)
    meshes = [to_mesh(m, cuda_device) for m in meshes]
    assert_bits(overlay2d.paint_meshes(img, meshes),
                overlay2d.paint_meshes_plain(img, meshes))


def test_r1_hud_matches_plain(cuda_device):  # noqa: F811
    img = torch.from_numpy(seeded_image(1080, 1920, 13)).to(cuda_device)
    meshes = overlay2d.hud_meshes(HUD_LINES, frame_ms=frame_times(120, 14),
                                  scale=2.0)
    got = overlay2d.hud_overlay(img, HUD_LINES, frame_ms=frame_times(120, 14),
                                scale=2.0)
    assert_bits(got, overlay2d.paint_meshes_plain(img, meshes))
    # The same on the CPU, as the CPU tests hold it to JAX.
    cpu = overlay2d.paint_meshes(img.cpu()[:200, :400].contiguous(), meshes)
    assert_bits(got[:200, :400], cpu)


def test_r1_refuses_bad_images(cuda_device):  # noqa: F811
    with pytest.raises(cuda_build.KernelError):
        cuda_overlay.paint_meshes(torch.zeros((4, 4, 4), device=cuda_device),
                                  [])
