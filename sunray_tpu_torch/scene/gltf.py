"""glTF 2.0 / GLB scene import — port of sunray_tpu/scene/gltf.py.

Re-implements the reference's import pipeline (src/vulkan_abstraction/gltf/
mod.rs + src/scene.rs) on numpy:

  - GLB container + .gltf JSON, buffer views/accessors (strides, all
    component types), data: URIs and external files.
  - Default-scene node walk with accumulated parent transforms; TRS or
    matrix nodes (gltf/mod.rs:164-189).
  - Primitive dedup by (position accessor, indices accessor)
    (gltf/mod.rs:200-212) -> one "primitive" (BLAS analog) per unique pair.
  - Materials: pbrMetallicRoughness + emissive (KHR_materials_
    emissive_strength — NOTE the reference defaults strength to 0.0 when
    the extension is absent, `unwrap_or(0.0)` gltf/mod.rs:222, diverging
    from the glTF-spec default of 1.0; we match the reference),
    KHR_materials_transmission, KHR_materials_ior (default 1.5),
    alphaMode/alphaCutoff, doubleSided.
  - Per-role texcoord set selection (gltf/mod.rs:232-238): each of the 5
    texture roles reads its own TEXCOORD_<n> set into the role's UV slot.
  - Emissive triangles: all triangles of primitives whose material has
    emissive strength > 0 or nonzero factor (gltf/mod.rs:270-296), emission
    = factor.rgb * strength (scene.rs:115-135).
  - Images decoded to RGBA float by the port's own PNG and JPEG readers
    (utils/png.read_png_rgba, utils/jpeg.read_jpeg_rgba, chosen by the
    image's magic bytes; bit-equal to PIL's convert("RGBA")); an image
    they cannot decode (16-bit or interlaced PNG, lossless, hierarchical
    or arithmetic-coded JPEG, other formats) raises NotImplementedError
    naming its type, a corrupt one ValueError. Sampled as LINEAR data
    (the reference uploads R8G8B8A8_UNORM, not SRGB — scene.rs:203-218 —
    so no sRGB decode).

Triangles only (gltf/mod.rs:363-372); other primitive modes are skipped
with a warning.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct

import numpy as np

from sunray_tpu_torch.scene.types import (
    ALPHA_BLEND,
    ALPHA_MASK,
    ALPHA_OPAQUE,
    NULL_TEXTURE,
    NUM_TEX_SLOTS,
    MaterialTable,
    SceneBuffers,
    TextureAtlas,
    WRAP_CLAMP,
    WRAP_MIRROR,
    WRAP_REPEAT,
    build_scene,
)

from sunray_tpu_torch.utils.jpeg import read_jpeg_rgba
from sunray_tpu_torch.utils.png import image_kind, read_png_rgba

log = logging.getLogger(__name__)

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16,
}
_ALPHA_MODES = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK, "BLEND": ALPHA_BLEND}
_WRAP = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR}


class GltfDocument:
    def __init__(self, path: str):
        self.base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            magic, version, _length = struct.unpack("<III", data[:12])
            assert version == 2, f"unsupported GLB version {version}"
            pos = 12
            self.json = None
            self.bin = None
            while pos < len(data):
                clen, ctype = struct.unpack("<II", data[pos : pos + 8])
                body = data[pos + 8 : pos + 8 + clen]
                pos += 8 + clen
                if ctype == 0x4E4F534A:  # JSON
                    self.json = json.loads(body)
                elif ctype == 0x004E4942:  # BIN
                    self.bin = body
        else:
            self.json = json.loads(data)
            self.bin = None
        self._buffers = [self._load_buffer(b) for b in self.json.get("buffers", [])]

    def _load_buffer(self, buf) -> bytes:
        uri = buf.get("uri")
        if uri is None:
            return self.bin
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(self.base_dir, uri), "rb") as f:
            return f.read()

    def buffer_view_bytes(self, bv_index: int) -> bytes:
        bv = self.json["bufferViews"][bv_index]
        buf = self._buffers[bv["buffer"]]
        off = bv.get("byteOffset", 0)
        return buf[off : off + bv["byteLength"]]

    def accessor(self, index: int) -> np.ndarray:
        """Read an accessor into (count, components) array."""
        acc = self.json["accessors"][index]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        out = np.zeros((count, ncomp), dtype)
        if "bufferView" in acc:
            bv = self.json["bufferViews"][acc["bufferView"]]
            buf = self._buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            elem_size = np.dtype(dtype).itemsize * ncomp
            stride = bv.get("byteStride") or elem_size
            if stride == elem_size:
                raw = np.frombuffer(
                    buf, dtype, count=count * ncomp, offset=start
                )
                out = raw.reshape(count, ncomp).copy()
            else:
                for i in range(count):
                    out[i] = np.frombuffer(
                        buf, dtype, count=ncomp, offset=start + i * stride
                    )
        # sparse accessors
        sp = acc.get("sparse")
        if sp:
            idx_acc = sp["indices"]
            idx_dtype = _COMPONENT_DTYPES[idx_acc["componentType"]]
            bv = self.json["bufferViews"][idx_acc["bufferView"]]
            buf = self._buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + idx_acc.get("byteOffset", 0)
            idx = np.frombuffer(buf, idx_dtype, count=sp["count"], offset=start)
            val = sp["values"]
            bv = self.json["bufferViews"][val["bufferView"]]
            buf = self._buffers[bv["buffer"]]
            start = bv.get("byteOffset", 0) + val.get("byteOffset", 0)
            vals = np.frombuffer(
                buf, dtype, count=sp["count"] * ncomp, offset=start
            ).reshape(sp["count"], ncomp)
            out[idx] = vals
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
        return out

    def accessor_f32(self, index: int) -> np.ndarray:
        return self.accessor(index).astype(np.float32)

    def image_rgba(self, img_index: int) -> np.ndarray:
        """Decode image -> (H, W, 4) float32 in [0, 1] (linear bytes)."""
        img = self.json["images"][img_index]
        if "bufferView" in img:
            raw = self.buffer_view_bytes(img["bufferView"])
        else:
            uri = img["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.base_dir, uri), "rb") as f:
                    raw = f.read()
        try:
            read = (read_jpeg_rgba if image_kind(raw) == "JPEG"
                    else read_png_rgba)
            arr = read(raw)
        except NotImplementedError as e:
            raise NotImplementedError(f"glTF image {img_index} "
                                      f"({img.get('mimeType', 'no mimeType')})"
                                      f": {e}") from None
        return arr.astype(np.float32) / 255.0


def _node_local_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        rot = np.asarray(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        m = np.block(
            [[rot @ m[:3, :3], m[:3, 3:4]], [np.zeros((1, 3), np.float32), 1.0]]
        ).astype(np.float32)
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _parse_material(doc: GltfDocument, mat) -> dict:
    pbr = mat.get("pbrMetallicRoughness", {})
    ext = mat.get("extensions", {})
    # Reference behavior: strength defaults to 0.0 WITHOUT the extension
    # (gltf/mod.rs:222 unwrap_or(0.0)).
    strength = ext.get("KHR_materials_emissive_strength", {}).get(
        "emissiveStrength", 0.0
    )
    emissive = list(mat.get("emissiveFactor", [0.0, 0.0, 0.0]))
    transmission = ext.get("KHR_materials_transmission", {}).get(
        "transmissionFactor", 0.0
    )
    ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)

    def tex_info(container, key):
        info = container.get(key)
        if info is None:
            return None, 0
        return info["index"], info.get("texCoord", 0)

    tex = [None] * NUM_TEX_SLOTS
    coords = [0] * NUM_TEX_SLOTS
    tex[0], coords[0] = tex_info(pbr, "baseColorTexture")
    tex[1], coords[1] = tex_info(pbr, "metallicRoughnessTexture")
    tex[2], coords[2] = tex_info(mat, "normalTexture")
    tex[3], coords[3] = tex_info(mat, "occlusionTexture")
    tex[4], coords[4] = tex_info(mat, "emissiveTexture")

    return {
        "base_color": pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]),
        "metallic": pbr.get("metallicFactor", 1.0),
        "roughness": pbr.get("roughnessFactor", 1.0),
        "emissive_factor": emissive + [strength],
        "alpha_mode": _ALPHA_MODES[mat.get("alphaMode", "OPAQUE")],
        "alpha_cutoff": mat.get("alphaCutoff", 0.5),
        "transmission": transmission,
        "ior": ior,
        "gltf_tex": tex,
        "gltf_tex_coords": coords,
        "double_sided": mat.get("doubleSided", False),
    }


def _build_atlas(doc: GltfDocument, used_textures, device="cuda") -> tuple:
    """Decode used textures into a padded atlas on `device`. Returns
    (TextureAtlas, {gltf_tex_index: atlas_index})."""
    if not used_textures:
        return TextureAtlas.empty(device), {}
    import torch

    textures = doc.json.get("textures", [])
    samplers = doc.json.get("samplers", [])
    imgs, sizes, wraps, filts = [], [], [], []
    remap = {}
    for ti in sorted(used_textures):
        t = textures[ti]
        arr = doc.image_rgba(t["source"])
        s = samplers[t["sampler"]] if t.get("sampler") is not None else {}
        wrap_u = _WRAP.get(s.get("wrapS", 10497), WRAP_REPEAT)
        wrap_v = _WRAP.get(s.get("wrapT", 10497), WRAP_REPEAT)
        # magFilter 9728 = NEAREST, else linear (scene.rs:246-253 mapping).
        filt = 0 if s.get("magFilter") == 9728 else 1
        remap[ti] = len(imgs)
        imgs.append(arr)
        sizes.append((arr.shape[1], arr.shape[0]))
        wraps.append((wrap_u, wrap_v))
        filts.append(filt)

    max_h = max(a.shape[0] for a in imgs)
    max_w = max(a.shape[1] for a in imgs)
    data = np.zeros((len(imgs), max_h, max_w, 4), np.float32)
    for i, a in enumerate(imgs):
        data[i, : a.shape[0], : a.shape[1]] = a
    atlas = TextureAtlas(
        data=torch.from_numpy(data).to(device),
        size=torch.from_numpy(np.asarray(sizes, np.int32)).to(device),
        wrap=torch.from_numpy(np.asarray(wraps, np.int32)).to(device),
        filt=torch.from_numpy(np.asarray(filts, np.int32)).to(device),
    )
    return atlas, remap


def load_gltf(path: str, device="cuda") -> SceneBuffers:
    """Load a .glb/.gltf file into SceneBuffers on `device` (the
    Gltf::create_default_scene + Scene::load_into_gpu pipeline,
    gltf/mod.rs:69-139 + scene.rs:52-94)."""
    doc = GltfDocument(path)
    j = doc.json

    scene_index = j.get("scene", 0)
    scene_nodes = j["scenes"][scene_index]["nodes"]

    # Walk nodes, collecting (mesh, primitive) instances with transforms.
    instances_raw = []  # (mesh_index, prim_index, world 4x4)

    def walk(node_index, parent):
        node = j["nodes"][node_index]
        world = parent @ _node_local_matrix(node)
        if "mesh" in node:
            mesh = j["meshes"][node["mesh"]]
            for pi in range(len(mesh["primitives"])):
                instances_raw.append((node["mesh"], pi, world))
        for ch in node.get("children", []):
            walk(ch, world)

    for n in scene_nodes:
        walk(n, np.eye(4, dtype=np.float32))

    # Unique primitives by (position accessor, indices accessor)
    # (gltf/mod.rs:200-212).
    prim_key_to_id = {}
    prim_records = []       # material dicts per unique primitive
    positions_all, normals_all, tangents_all, uvs_all = [], [], [], []
    tri_vidx_all, prim_of_tri_all = [], []
    vert_offset = 0
    used_textures = set()
    materials_json = j.get("materials", [])

    def process_primitive(mesh_index, prim_index):
        nonlocal vert_offset
        mesh = j["meshes"][mesh_index]
        prim = mesh["primitives"][prim_index]
        if prim.get("mode", 4) != 4:
            log.error("unsupported primitive mode %s", prim.get("mode"))
            return None
        attrs = prim["attributes"]
        pos_acc = attrs["POSITION"]
        idx_acc = prim.get("indices", -1000 - prim_index)
        key = (pos_acc, idx_acc)
        if key in prim_key_to_id:
            return prim_key_to_id[key]

        positions = doc.accessor_f32(pos_acc)
        count = positions.shape[0]
        normals = (
            doc.accessor_f32(attrs["NORMAL"])
            if "NORMAL" in attrs
            else np.zeros((count, 3), np.float32)
        )
        tangents = (
            doc.accessor_f32(attrs["TANGENT"])
            if "TANGENT" in attrs
            else np.zeros((count, 4), np.float32)
        )
        if "indices" in prim:
            indices = doc.accessor(prim["indices"]).reshape(-1).astype(np.int64)
        else:
            indices = np.arange(count, dtype=np.int64)
        tris = indices.reshape(-1, 3)

        mat_index = prim.get("material")
        mat = (
            _parse_material(doc, materials_json[mat_index])
            if mat_index is not None
            else _parse_material(doc, {})
        )

        # Per-role texcoord sets (gltf/mod.rs:338-342).
        uvs = np.zeros((count, NUM_TEX_SLOTS, 2), np.float32)
        for role in range(NUM_TEX_SLOTS):
            set_i = mat["gltf_tex_coords"][role]
            acc = attrs.get(f"TEXCOORD_{set_i}")
            if acc is not None:
                uvs[:, role, :] = doc.accessor_f32(acc)[:, :2]
        for t in mat["gltf_tex"]:
            if t is not None:
                used_textures.add(t)

        pid = len(prim_records)
        prim_key_to_id[key] = pid
        prim_records.append(mat)
        positions_all.append(positions)
        normals_all.append(normals)
        tangents_all.append(tangents)
        uvs_all.append(uvs)
        tri_vidx_all.append(tris + vert_offset)
        prim_of_tri_all.append(np.full(tris.shape[0], pid, np.int32))
        vert_offset += count
        return pid

    instance_list = []
    for mesh_index, prim_index, world in instances_raw:
        pid = process_primitive(mesh_index, prim_index)
        if pid is None:
            continue
        instance_list.append((pid, world[:3, :4].astype(np.float32)))

    atlas, remap = _build_atlas(doc, used_textures, device)

    mat_records = []
    for r in prim_records:
        tex_slots = [
            remap.get(t, NULL_TEXTURE) if t is not None else NULL_TEXTURE
            for t in r["gltf_tex"]
        ]
        mat_records.append(
            {
                "base_color": r["base_color"],
                "metallic": r["metallic"],
                "roughness": r["roughness"],
                "emissive_factor": r["emissive_factor"],
                "alpha_mode": r["alpha_mode"],
                "alpha_cutoff": r["alpha_cutoff"],
                "transmission": r["transmission"],
                "ior": r["ior"],
                "tex_index": tex_slots,
            }
        )

    return build_scene(
        positions=np.concatenate(positions_all)
        if positions_all
        else np.zeros((0, 3), np.float32),
        normals=np.concatenate(normals_all)
        if normals_all
        else np.zeros((0, 3), np.float32),
        tri_vidx=np.concatenate(tri_vidx_all).astype(np.int32)
        if tri_vidx_all
        else np.zeros((0, 3), np.int32),
        prim_of_tri=np.concatenate(prim_of_tri_all)
        if prim_of_tri_all
        else np.zeros((0,), np.int32),
        materials=MaterialTable.build(mat_records or [{}], device=device),
        instances=instance_list,
        tangents=np.concatenate(tangents_all) if tangents_all else None,
        uvs=np.concatenate(uvs_all) if uvs_all else None,
        textures=atlas,
        device=device,
    )
