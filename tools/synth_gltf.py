"""A seeded synthetic glTF scene: the reflection room with textures, an
alpha-cutout panel grid and an instanced icosphere, written with no assets
and no network.

    python3 tools/synth_gltf.py out.glb [--tex 1024] [--subdiv 4] [--spheres 50]

write_scene(path, ...) writes it as a GLB (binary chunk; images in buffer
views), a .gltf with its buffer as a data: URI, or a .gltf with an
external .bin beside it; write_jpeg_scene(path, jpegs) a .gltf whose
images are the given JPEG files. The scene:

  - the shell of scene/procedural.reflection_room: floor, ceiling, mirror
    back wall, two side walls, the area light, a glass box
    (KHR_materials_transmission, KHR_materials_ior) and a white box;
  - eight RGBA PNG textures of tex x tex texels: the floor's base colour
    (repeat wrap, bilinear), its normal map (read through TEXCOORD_1, a
    normalized uint16 accessor) and its metallic-roughness map; the side
    walls' base colour (mirrored repeat, nearest); the ceiling's base
    colour (repeat, nearest); the light's emissive texture
    (KHR_materials_emissive_strength); the cutout's alpha (clamp, nearest)
    on a 16-quad MASK panel grid; the spheres' base colour;
  - an icosphere of 20 * 4^subdiv triangles (5,120 at subdiv 4) under a
    parent node, instanced `spheres` times by node TRS (one instance by a
    matrix), so a scene of >= 2 instances of small meshes. 50 instances
    make 256,068 triangles, whose capacity padding (to 262,144, scene/
    manager.py) is small enough that the Renderer's "auto" takes the
    two-level tracer: the padding counts to instance 0 there;
  - the room's vertices interleaved in one strided buffer view, uint16
    room indices and uint32 sphere indices.

CAMERA looks into the open side of the room.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import struct

import numpy as np

from sunray_tpu_torch.utils.png import encode_png

CAMERA = dict(position=(2.0, 2.1, 7.2), target=(2.0, 1.5, 0.0), fov_y=50.0)
ROOM = 4.0
REPEAT, CLAMP, MIRROR = 10497, 33071, 33648
NEAREST, LINEAR = 9728, 9729


def icosphere(subdiv: int):
    """(positions (V, 3), triangles (T, 3)) of a unit icosphere."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
         (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
         (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
         (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
         (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(subdiv):
        mid, nf = {}, []

        def m(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = nf
    return np.asarray(verts, np.float32), np.asarray(f, np.int64)


def _textures(g, n):
    """The eight (n, n, 4) uint8 images, in the order of TEXTURES."""
    yy, xx = np.mgrid[0:n, 0:n] / n
    noise = g.random((n, n))

    def rgba(r, gg, b, a=None):
        a = np.ones_like(r) if a is None else a
        return (np.clip(np.stack([r, gg, b, a], -1), 0, 1) * 255 + 0.5).astype(
            np.uint8)

    check = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2)
    floor = rgba(0.55 + 0.3 * check, 0.5 + 0.25 * check, 0.4 + 0.1 * noise)
    hx = np.sin(xx * 2 * np.pi * 6) * 0.35
    hy = np.cos(yy * 2 * np.pi * 6) * 0.35
    nrm = np.stack([hx, hy, np.ones_like(hx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = rgba(*(nrm * 0.5 + 0.5).transpose(2, 0, 1))
    mr = rgba(np.zeros_like(xx), 0.2 + 0.7 * noise, check)
    stripes = (np.floor(xx * 6) % 2)
    walls = rgba(0.2 + 0.5 * stripes, 0.3 + 0.2 * noise, 0.7 - 0.3 * stripes)
    ceiling = rgba(0.8 - 0.2 * noise, 0.8 - 0.2 * noise, 0.8 - 0.1 * noise)
    glow = 0.6 + 0.4 * np.cos((xx - 0.5) * np.pi) * np.cos((yy - 0.5) * np.pi)
    emissive = rgba(glow, 0.9 * glow, 0.8 * glow)
    holes = (((xx * 4) % 1 - 0.5) ** 2 + ((yy * 4) % 1 - 0.5) ** 2) > 0.09
    cutout = rgba(0.9 * np.ones_like(xx), 0.6 + 0.2 * noise, 0.3 * noise,
                  holes.astype(np.float64))
    sphere = rgba(0.3 + 0.6 * (np.floor(yy * 10) % 2), 0.4 + 0.4 * noise,
                  0.9 - 0.5 * xx)
    return [floor, normal, mr, walls, ceiling, emissive, cutout, sphere]


# (name, wrapS, wrapT, magFilter) of each texture.
TEXTURES = [("floor_base", REPEAT, REPEAT, LINEAR),
            ("floor_normal", REPEAT, REPEAT, LINEAR),
            ("floor_mr", REPEAT, REPEAT, LINEAR),
            ("wall_base", MIRROR, MIRROR, NEAREST),
            ("ceiling_base", REPEAT, REPEAT, NEAREST),
            ("light_emissive", CLAMP, CLAMP, LINEAR),
            ("cutout", CLAMP, CLAMP, NEAREST),
            ("sphere_base", REPEAT, MIRROR, LINEAR)]


class _Bin:
    """The binary buffer, its buffer views and accessors."""

    def __init__(self):
        self.data = bytearray()
        self.views, self.accessors = [], []

    def view(self, raw: bytes, stride=None, target=None) -> int:
        while len(self.data) % 4:
            self.data += b"\0"
        v = {"buffer": 0, "byteOffset": len(self.data), "byteLength": len(raw)}
        if stride:
            v["byteStride"] = stride
        if target:
            v["target"] = target
        self.data += raw
        self.views.append(v)
        return len(self.views) - 1

    def accessor(self, view, ctype, count, typ, offset=0, minmax=None,
                 normalized=False) -> int:
        a = {"bufferView": view, "componentType": ctype, "count": count,
             "type": typ}
        if offset:
            a["byteOffset"] = offset
        if normalized:
            a["normalized"] = True
        if minmax is not None:
            a["min"], a["max"] = [float(x) for x in minmax[0]], [
                float(x) for x in minmax[1]]
        self.accessors.append(a)
        return len(self.accessors) - 1

    def array(self, arr, ctype, typ, target=None, normalized=False) -> int:
        arr = np.ascontiguousarray(arr)
        mm = ((arr.min(axis=0), arr.max(axis=0)) if typ == "VEC3" else None)
        return self.accessor(self.view(arr.tobytes(), target=target), ctype,
                             arr.shape[0], typ, minmax=mm, normalized=normalized)


def _quad(p0, p1, p2, p3, uv_scale=1.0):
    """Four corners, their normal, uvs, tangent; two triangles."""
    p = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(p[1] - p[0], p[3] - p[0])
    n /= np.linalg.norm(n)
    uv = np.asarray([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32) * uv_scale
    tan = np.append((p[1] - p[0]) / np.linalg.norm(p[1] - p[0]), 1.0)
    return p, np.tile(n, (4, 1)), uv, np.tile(tan, (4, 1)).astype(np.float32)


def _box(center, size, rot_y=0.0):
    """24 corners (4 a face), normals, uvs; 12 triangles (procedural.py's
    add_box winding, every normal outward)."""
    sx, sy, sz = (s / 2.0 for s in size)
    c = np.array([[-sx, -sy, -sz], [sx, -sy, -sz], [sx, -sy, sz], [-sx, -sy, sz],
                  [-sx, sy, -sz], [sx, sy, -sz], [sx, sy, sz], [-sx, sy, sz]],
                 np.float32)
    if rot_y:
        cs, sn = np.cos(rot_y), np.sin(rot_y)
        c = c @ np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]], np.float32).T
    c += np.asarray(center, np.float32)
    b, t = c[:4], c[4:]
    faces = [(b[0], b[1], b[2], b[3]), (t[0], t[3], t[2], t[1]),
             (b[0], t[0], t[1], b[1]), (b[1], t[1], t[2], b[2]),
             (b[2], t[2], t[3], b[3]), (b[3], t[3], t[0], b[0])]
    return [_quad(*f) for f in faces]


def _quat_y(angle):
    return [0.0, float(np.sin(angle / 2)), 0.0, float(np.cos(angle / 2))]


def build_document(seed=0, tex=1024, subdiv=4, spheres=50, index16=True):
    """(glTF JSON dict, binary buffer bytes)."""
    g = np.random.default_rng(seed)
    s = ROOM
    b = _Bin()
    images = []
    for img in _textures(g, tex):
        images.append({"bufferView": b.view(encode_png(img)),
                       "mimeType": "image/png"})
    samplers = [{"wrapS": ws, "wrapT": wt, "magFilter": mf, "minFilter": mf}
                for _, ws, wt, mf in TEXTURES]
    textures = [{"sampler": i, "source": i} for i in range(len(TEXTURES))]

    def tex(i, coord=0):
        info = {"index": i}
        if coord:
            info["texCoord"] = coord
        return info

    materials = [
        {"name": "floor", "pbrMetallicRoughness": {
            "baseColorTexture": tex(0), "metallicRoughnessTexture": tex(2),
            "metallicFactor": 0.6, "roughnessFactor": 1.0},
         "normalTexture": tex(1, coord=1)},
        {"name": "ceiling", "pbrMetallicRoughness": {
            "baseColorTexture": tex(4), "metallicFactor": 0.0,
            "roughnessFactor": 0.9}},
        {"name": "mirror", "pbrMetallicRoughness": {
            "baseColorFactor": [0.95, 0.95, 0.95, 1.0], "metallicFactor": 1.0,
            "roughnessFactor": 0.02}},
        {"name": "walls", "pbrMetallicRoughness": {
            "baseColorTexture": tex(3), "metallicFactor": 0.0,
            "roughnessFactor": 0.6}},
        {"name": "light", "pbrMetallicRoughness": {"metallicFactor": 0.0},
         "emissiveFactor": [1.0, 0.95, 0.9], "emissiveTexture": tex(5),
         "extensions": {"KHR_materials_emissive_strength":
                        {"emissiveStrength": 12.0}}},
        {"name": "glass", "pbrMetallicRoughness": {
            "baseColorFactor": [0.95, 0.95, 0.98, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.02},
         "extensions": {"KHR_materials_transmission": {"transmissionFactor": 1.0},
                        "KHR_materials_ior": {"ior": 1.45}}},
        {"name": "white", "pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.7, 0.7, 1.0], "metallicFactor": 0.0,
            "roughnessFactor": 0.9}},
        {"name": "cutout", "alphaMode": "MASK", "alphaCutoff": 0.5,
         "doubleSided": True, "pbrMetallicRoughness": {
             "baseColorTexture": tex(6), "metallicFactor": 0.0,
             "roughnessFactor": 0.7}},
        {"name": "sphere", "pbrMetallicRoughness": {
            "baseColorTexture": tex(7), "metallicFactor": 0.1,
            "roughnessFactor": 0.4}},
    ]

    # Room meshes: (material, quads); their vertices interleaved
    # (position, normal, uv: 32 bytes a vertex) in one strided view.
    ly = s - 0.02
    room = [
        (0, [_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), uv_scale=3.0)]),
        (1, [_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), uv_scale=2.0)]),
        (2, [_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0))]),
        (3, [_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), uv_scale=2.5),
             _quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0), uv_scale=2.5)]),
        (4, [_quad((s * .35, ly, s * .35), (s * .65, ly, s * .35),
                   (s * .65, ly, s * .65), (s * .35, ly, s * .65))]),
        (5, _box((s * 0.3, 0.5, s * 0.55), (1.0, 1.0, 1.0))),
        (6, _box((s * 0.7, 0.4, s * 0.35), (0.8, 0.8, 0.8), rot_y=0.5)),
    ]
    # The MASK panel grid: 4 x 4 quads standing at z = 2.6.
    panel = []
    for i in range(4):
        for j in range(4):
            x0, y0 = 0.3 + 0.32 * i, 0.15 + 0.32 * j
            panel.append(_quad((x0, y0, 2.6), (x0 + 0.3, y0, 2.6),
                               (x0 + 0.3, y0 + 0.3, 2.6), (x0, y0 + 0.3, 2.6)))
    room.append((7, panel))

    verts, idx_all, ranges = [], [], []
    base = 0
    for mat, quads in room:
        first = sum(len(x) for x in idx_all)
        for p, n, uv, _ in quads:
            verts.append(np.concatenate([p, n, uv], axis=1))
            idx_all.append(np.asarray([base, base + 1, base + 2, base,
                                       base + 2, base + 3]))
            base += 4
        ranges.append((mat, first, sum(len(x) for x in idx_all) - first))
    inter = np.concatenate(verts).astype(np.float32)         # (V, 8)
    vview = b.view(inter.tobytes(), stride=32, target=34962)
    pos_acc = b.accessor(vview, 5126, inter.shape[0], "VEC3",
                         minmax=(inter[:, :3].min(0), inter[:, :3].max(0)))
    nrm_acc = b.accessor(vview, 5126, inter.shape[0], "VEC3", offset=12)
    uv_acc = b.accessor(vview, 5126, inter.shape[0], "VEC2", offset=24)
    idx = np.concatenate(idx_all).astype(np.uint16 if index16 else np.uint32)
    iview = b.view(idx.tobytes(), target=34963)
    meshes, nodes = [], []
    for mat, first, count in ranges:
        ia = b.accessor(iview, 5123 if index16 else 5125, count, "SCALAR",
                        offset=first * idx.itemsize)
        meshes.append({"primitives": [{
            "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc,
                           "TEXCOORD_0": uv_acc},
            "indices": ia, "material": mat}]})
    # The floor gets its own tangents and a second uv set (normalized
    # uint16) for the normal map: a primitive of its own accessors.
    fp, fn, fuv, ft = room[0][1][0]
    uv1 = np.clip(fuv / 3.0 * 2.0, 0, 1)
    floor_prim = meshes[0]["primitives"][0]
    floor_prim["attributes"] = {
        "POSITION": b.array(fp, 5126, "VEC3", 34962),
        "NORMAL": b.array(fn, 5126, "VEC3", 34962),
        "TANGENT": b.array(ft, 5126, "VEC4", 34962),
        "TEXCOORD_0": b.array(fuv, 5126, "VEC2", 34962),
        "TEXCOORD_1": b.array((uv1 * 65535 + 0.5).astype(np.uint16), 5123,
                              "VEC2", 34962, normalized=True)}
    floor_prim["indices"] = b.array(np.asarray([0, 1, 2, 0, 2, 3], np.uint16),
                                    5123, "SCALAR", 34963)

    # The icosphere: its own (non-interleaved) views, uint32 indices.
    sp, st = icosphere(subdiv)
    theta = np.arctan2(sp[:, 2], sp[:, 0])
    suv = np.stack([theta / (2 * np.pi) + 0.5,
                    np.arccos(np.clip(sp[:, 1], -1, 1)) / np.pi], 1)
    meshes.append({"primitives": [{
        "attributes": {"POSITION": b.array(sp, 5126, "VEC3", 34962),
                       "NORMAL": b.array(sp, 5126, "VEC3", 34962),
                       "TEXCOORD_0": b.array(suv.astype(np.float32), 5126,
                                             "VEC2", 34962)},
        "indices": b.array(st.reshape(-1).astype(np.uint32), 5125, "SCALAR",
                           34963),
        "material": 8}]})
    sphere_mesh = len(meshes) - 1

    room_children = list(range(len(ranges)))
    nodes = [{"mesh": m} for m in room_children]
    sphere_children = []
    cols = 8
    for k in range(spheres):
        r = 0.16 + 0.06 * g.random()
        x = 0.45 + (k % cols) * (s - 0.9) / (cols - 1) + g.uniform(-0.08, 0.08)
        z = 0.45 + (k // cols) * 0.42 + g.uniform(-0.05, 0.05)
        y = r + 0.02 + 1.6 * g.random() * (k % 3 == 0)
        node = {"mesh": sphere_mesh}
        if k == 1:
            m = np.eye(4)
            m[:3, :3] *= r
            m[:3, 3] = (x, y - 0.1, z)
            node["matrix"] = [float(v) for v in m.T.reshape(-1)]
        else:
            node.update(translation=[x, y - 0.1, z], scale=[r, r * 1.1, r],
                        rotation=_quat_y(g.uniform(0, np.pi)))
        nodes.append(node)
        sphere_children.append(len(nodes) - 1)
    # A parent with its own TRS: the spheres' world transforms compose.
    nodes.append({"name": "spheres", "translation": [0.0, 0.1, 0.0],
                  "rotation": _quat_y(0.0), "children": sphere_children})
    nodes.append({"name": "room", "children": room_children})
    doc = {
        "asset": {"version": "2.0", "generator": "tools/synth_gltf.py"},
        "extensionsUsed": ["KHR_materials_emissive_strength",
                           "KHR_materials_transmission", "KHR_materials_ior"],
        "scene": 0,
        "scenes": [{"nodes": [len(nodes) - 1, len(nodes) - 2]}],
        "nodes": nodes, "meshes": meshes, "materials": materials,
        "textures": textures, "samplers": samplers, "images": images,
        "accessors": b.accessors, "bufferViews": b.views,
        "buffers": [{"byteLength": len(b.data)}],
    }
    return doc, bytes(b.data)


def write_scene(path, seed=0, tex=1024, subdiv=4, spheres=50, fmt="glb",
                index16=True):
    """Write the scene to `path`: fmt "glb", "gltf-data" (the buffer as a
    data: URI) or "gltf-external" (the buffer in path + ".bin")."""
    doc, data = build_document(seed, tex, subdiv, spheres, index16)
    if fmt == "glb":
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        data += b"\0" * (-len(data) % 4)
        body = (struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(data), 0x004E4942) + data)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)
        return path
    if fmt == "gltf-data":
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(data).decode())
    elif fmt == "gltf-external":
        name = os.path.basename(path) + ".bin"
        with open(os.path.join(os.path.dirname(os.path.abspath(path)), name),
                  "wb") as f:
            f.write(data)
        doc["buffers"][0]["uri"] = name
    else:
        raise ValueError(f"unknown format {fmt!r}")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_jpeg_scene(path, jpegs, as_views=False, seed=5, tex=8, subdiv=0,
                     spheres=2):
    """Write the scene as a .gltf whose images are the JPEG files `jpegs`
    in turn (image i is jpegs[i % len(jpegs)]): as data: URIs, or with
    as_views appended to the buffer as buffer views (mimeType
    image/jpeg). The buffer is a data: URI."""
    doc, data = build_document(seed, tex, subdiv, spheres)
    data = bytearray(data)
    blobs = []
    for p in jpegs:
        with open(p, "rb") as f:
            blobs.append(f.read())
    for i in range(len(doc["images"])):
        blob = blobs[i % len(blobs)]
        if as_views:
            data += b"\0" * (-len(data) % 4)
            doc["bufferViews"].append({"buffer": 0, "byteOffset": len(data),
                                       "byteLength": len(blob)})
            data += blob
            doc["images"][i] = {"bufferView": len(doc["bufferViews"]) - 1,
                                "mimeType": "image/jpeg"}
        else:
            doc["images"][i] = {"uri": "data:image/jpeg;base64,"
                                + base64.b64encode(blob).decode()}
    doc["buffers"] = [{"byteLength": len(data), "uri":
                       "data:application/octet-stream;base64,"
                       + base64.b64encode(bytes(data)).decode()}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tex", type=int, default=1024)
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--spheres", type=int, default=50)
    ap.add_argument("--fmt", default="glb",
                    choices=["glb", "gltf-data", "gltf-external"])
    a = ap.parse_args()
    write_scene(a.path, a.seed, a.tex, a.subdiv, a.spheres, a.fmt)


if __name__ == "__main__":
    main()
