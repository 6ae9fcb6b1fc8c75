"""PyTorch port, a glTF with JPEG textures: a tools/synth_gltf.py document
whose images are the repo's two JPEGs (docs/renders/web_viewer_*.jpg),
as data: URIs and as buffer views, loaded by the port's load_gltf (its
own decoder, utils/jpeg.py) and by the JAX package's (PIL): the texture
atlas and every other SceneBuffers array bit-equal
(tools/synth_gltf.write_jpeg_scene writes the document)."""

import os

import pytest

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu.scene.gltf import load_gltf as jload_gltf
from sunray_tpu_torch.scene.gltf import load_gltf
from test_torch_gltf import assert_scene_equal
from tools.synth_gltf import write_jpeg_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = [os.path.join(REPO, "docs", "renders", f"web_viewer_{k}.jpg")
         for k in ("frame", "spawned")]


@pytest.mark.parametrize("as_views", [False, True],
                         ids=["data_uri", "buffer_view"])
def test_jpeg_atlas_matches_jax(tmp_path, as_views):
    path = write_jpeg_scene(str(tmp_path / "jpeg.gltf"), JPEGS, as_views)
    jscene = jload_gltf(path)
    pscene = load_gltf(path, device="cpu")
    assert tuple(pscene.textures.data.shape) == (8, 270, 480, 4)
    assert_scene_equal(jscene, pscene)
