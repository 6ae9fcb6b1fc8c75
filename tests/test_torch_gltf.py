"""PyTorch port, scene/gltf.py (with utils/png.py's reader) and
procedural.reflection_room: every SceneBuffers array equal to JAX's
load_gltf of the same synthetic files (tools/synth_gltf.py: GLB with its
images in buffer views, .gltf with a data: URI buffer, .gltf with an
external .bin; a node hierarchy with TRS and matrix nodes, uint16 and
uint32 indices, a strided interleaved vertex view, a normalized uint16
uv set, per-texture samplers, alpha MASK, and the emissive-strength,
transmission and ior extensions); a glTF without textures; an image the
port's PNG reader cannot decode raising NotImplementedError naming it."""

import base64
import io
import json

import numpy as np
import pytest
from PIL import Image

from sunray_tpu.scene.gltf import load_gltf as jload_gltf
from sunray_tpu.scene.procedural import reflection_room as jreflection_room
from sunray_tpu_torch.scene import procedural
from sunray_tpu_torch.scene.gltf import load_gltf
from sunray_tpu_torch.scene.types import ALPHA_MASK
from tools.synth_gltf import build_document, write_scene
from torch_parity import n, to_numpy


def assert_scene_equal(jscene, pscene):
    def walk(want, got, pre=""):
        for k, v in want.items():
            g = getattr(got, k)
            if isinstance(v, dict):
                walk(v, g, f"{pre}{k}.")
            elif v is None:
                assert g is None, pre + k
            else:
                np.testing.assert_array_equal(n(g), v, err_msg=pre + k)
    walk(to_numpy(jscene), pscene)


@pytest.mark.parametrize("fmt,index16", [("glb", True), ("glb", False),
                                         ("gltf-data", True),
                                         ("gltf-external", False)])
def test_load_matches_jax(tmp_path, fmt, index16):
    path = write_scene(str(tmp_path / f"scene.{fmt}"), seed=3, tex=12,
                       subdiv=1, spheres=5, fmt=fmt, index16=index16)
    jscene = jload_gltf(path)
    pscene = load_gltf(path, device="cpu")
    assert_scene_equal(jscene, pscene)
    assert pscene.num_lights == 2                   # the light quad
    assert tuple(pscene.textures.data.shape) == (8, 12, 12, 4)
    mats = pscene.materials
    assert int((mats.alpha_mode == ALPHA_MASK).sum()) == 1
    assert float(mats.transmission.max()) == 1.0
    assert float(mats.emissive_factor[:, 3].max()) == 12.0


def _write_gltf(path, doc, data):
    doc = dict(doc, buffers=[{"byteLength": len(data), "uri":
                              "data:application/octet-stream;base64,"
                              + base64.b64encode(data).decode()}])
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


def test_untextured_gltf(tmp_path):
    doc, data = build_document(seed=1, tex=4, subdiv=0, spheres=2)
    for key in ("images", "textures", "samplers"):
        doc.pop(key)
    for mat in doc["materials"]:
        for slot in ("normalTexture", "emissiveTexture"):
            mat.pop(slot, None)
        pbr = mat.get("pbrMetallicRoughness", {})
        pbr.pop("baseColorTexture", None)
        pbr.pop("metallicRoughnessTexture", None)
    path = _write_gltf(tmp_path / "plain.gltf", doc, data)
    pscene = load_gltf(path, device="cpu")
    assert pscene.textures.trivial
    assert_scene_equal(jload_gltf(path), pscene)


def test_undecodable_image_raises(tmp_path):
    """A GIF: PIL decodes it, the port's readers (utils/png.py,
    utils/jpeg.py) name it and refuse. (A progressive JPEG, refused until
    utils/jpeg.py decoded it, is tests/test_torch_jpeg_progressive.py's.)"""
    doc, data = build_document(seed=2, tex=8, subdiv=0, spheres=2)
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), 128, np.uint8)).save(buf, format="GIF")
    doc["images"][3] = {"uri": "data:image/gif;base64,"
                        + base64.b64encode(buf.getvalue()).decode()}
    path = _write_gltf(tmp_path / "gif.gltf", doc, data)
    jload_gltf(path)                       # PIL decodes it in the reference
    with pytest.raises(NotImplementedError, match="GIF"):
        load_gltf(path, device="cpu")


def test_reflection_room_matches_jax():
    assert_scene_equal(jreflection_room(), procedural.reflection_room(
        device="cpu"))
