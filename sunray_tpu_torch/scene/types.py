"""Scene data model — port of sunray_tpu/scene/types.py.

Dataclasses of tensors with the JAX package's field names and layouts.
Every tensor of one scene lives on one device; the frame follows it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sunray_tpu_torch.ops.fp import dot3

NULL_TEXTURE = -1  # reference: u32::MAX (rt_types.slang:192); -1 for int32

# glTF alpha modes (resources/material.rs)
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

# Texture slot roles (resources/material.rs:18-58)
TEX_BASE_COLOR = 0
TEX_METALLIC_ROUGHNESS = 1
TEX_NORMAL = 2
TEX_OCCLUSION = 3
TEX_EMISSIVE = 4
NUM_TEX_SLOTS = 5

# Sampler wrap modes
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2


def _tensors_to(obj, device):
    """A copy of dataclass `obj` with every tensor field moved to `device`."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if torch.is_tensor(v):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _tensors_to(v, device)
        out[f.name] = v
    return type(obj)(**out)


@dataclasses.dataclass
class TextureAtlas:
    """data (N, H, W, 4) f32, size (N, 2) i32, wrap (N, 2) i32, filt (N,) i32."""

    data: torch.Tensor
    size: torch.Tensor
    wrap: torch.Tensor
    filt: torch.Tensor

    @staticmethod
    def empty(device="cuda") -> "TextureAtlas":
        return TextureAtlas(
            data=torch.ones((1, 1, 1, 4), dtype=torch.float32, device=device),
            size=torch.ones((1, 2), dtype=torch.int32, device=device),
            wrap=torch.zeros((1, 2), dtype=torch.int32, device=device),
            filt=torch.ones((1,), dtype=torch.int32, device=device),
        )

    @property
    def trivial(self) -> bool:
        """The static 1x1x1 atlas of a textureless scene."""
        return tuple(self.data.shape[:3]) == (1, 1, 1)

    def to(self, device) -> "TextureAtlas":
        return _tensors_to(self, device)


def merge_atlases(a: Optional[TextureAtlas], b: Optional[TextureAtlas]):
    """Stack two atlases -> (merged, offset): texture i of b becomes
    texture offset + i, both padded to the common H x W (sizes stay per
    texture, so sampling is unchanged; types.py:79-105). On a's device."""
    if a is None:
        return b, 0
    if b is None:
        return a, 0
    h = max(a.data.shape[1], b.data.shape[1])
    w = max(a.data.shape[2], b.data.shape[2])
    dev = a.data.device

    def pad(d):
        return torch.nn.functional.pad(
            d.to(dev), (0, 0, 0, w - d.shape[2], 0, h - d.shape[1]))

    merged = TextureAtlas(
        data=torch.cat([pad(a.data), pad(b.data)]),
        size=torch.cat([a.size, b.size.to(dev)]),
        wrap=torch.cat([a.wrap, b.wrap.to(dev)]),
        filt=torch.cat([a.filt, b.filt.to(dev)]),
    )
    return merged, a.data.shape[0]


@dataclasses.dataclass
class MaterialTable:
    """Per-primitive PBR materials (SoA twin of resources/material.rs:18-58)."""

    base_color: torch.Tensor        # (M, 4)
    metallic: torch.Tensor          # (M,)
    roughness: torch.Tensor         # (M,)
    emissive_factor: torch.Tensor   # (M, 4) rgb + strength in w
    alpha_mode: torch.Tensor        # (M,) int32
    alpha_cutoff: torch.Tensor      # (M,)
    transmission: torch.Tensor      # (M,)
    ior: torch.Tensor               # (M,)
    tex_index: torch.Tensor         # (M, 5) int32, NULL_TEXTURE = none

    @staticmethod
    def build(records: list, device="cuda") -> "MaterialTable":
        """records: list of dicts with the scalar fields above."""
        m = len(records)

        def col(key, default, shape=()):
            out = np.zeros((m,) + shape, np.float32)
            for i, r in enumerate(records):
                out[i] = np.asarray(r.get(key, default), np.float32)
            return torch.from_numpy(out).to(device)

        tex = np.full((m, NUM_TEX_SLOTS), NULL_TEXTURE, np.int32)
        for i, r in enumerate(records):
            tex[i] = np.asarray(r.get("tex_index", [NULL_TEXTURE] * 5), np.int32)
        alpha = np.asarray(
            [int(r.get("alpha_mode", ALPHA_OPAQUE)) for r in records], np.int32
        )
        return MaterialTable(
            base_color=col("base_color", (1.0, 1.0, 1.0, 1.0), (4,)),
            metallic=col("metallic", 0.0),
            roughness=col("roughness", 1.0),
            emissive_factor=col("emissive_factor", (0.0, 0.0, 0.0, 0.0), (4,)),
            alpha_mode=torch.from_numpy(alpha).to(device),
            alpha_cutoff=col("alpha_cutoff", 0.5),
            transmission=col("transmission", 0.0),
            ior=col("ior", 1.5),
            tex_index=torch.from_numpy(tex).to(device),
        )


@dataclasses.dataclass
class SceneBuffers:
    """The traced scene: geometry + instances + materials + emissives.

    Same fields as sunray_tpu.scene.types.SceneBuffers: a shared vertex
    pool, the world triangle list expanded over instances, per-instance
    (3, 4) object->world transforms, and the emissive light indirection.
    """

    positions: torch.Tensor       # (V, 3)
    normals: torch.Tensor         # (V, 3)
    tangents: torch.Tensor        # (V, 4)
    uvs: torch.Tensor             # (V, 5, 2)
    tri_vidx: torch.Tensor        # (T, 3) int32 into the vertex pool
    tri_inst: torch.Tensor        # (T,) int32 instance id
    inst_transform: torch.Tensor  # (I, 3, 4) object->world
    inst_prim: torch.Tensor       # (I,) int32 primitive (material slot)
    materials: MaterialTable
    textures: TextureAtlas
    emissive_v: torch.Tensor      # (E, 3, 3) local triangle vertices
    emissive_rgb: torch.Tensor    # (E, 3)
    emissive_prim: torch.Tensor   # (E,) int32
    light_tri: torch.Tensor       # (L,) int32 into emissive_*
    light_inst: torch.Tensor      # (L,) int32 into instances
    light_world_tri: torch.Tensor  # (L,) int32 into the world triangle list
    edge_tri: Optional[torch.Tensor] = None
    edge_k: Optional[torch.Tensor] = None

    @property
    def num_tris(self) -> int:
        return self.tri_vidx.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_tri.shape[0]

    @property
    def has_alpha_mask(self) -> bool:
        return bool((self.materials.alpha_mode == ALPHA_MASK).any())

    def world_triangle_vertices(self):
        """(v0, v1, v2) world-space positions, each (T, 3)."""
        p = self.positions[self.tri_vidx.long()]              # (T, 3, 3)
        xf = self.inst_transform[self.tri_inst.long()]        # (T, 3, 4)
        pw = _transform_points(xf, p)
        return pw[:, 0], pw[:, 1], pw[:, 2]

    def light_world_triangles(self):
        """World-space emissive triangles: (L,3,3) verts + (L,3) emission."""
        v = self.emissive_v[self.light_tri.long()]            # (L, 3, 3)
        xf = self.inst_transform[self.light_inst.long()]      # (L, 3, 4)
        return _transform_points(xf, v), self.emissive_rgb[self.light_tri.long()]


def _transform_points(xf, p):
    """out[t, k, i] = sum_j xf[t, i, j] * p[t, k, j] + xf[t, i, 3], as fp32
    elementwise multiply-sums (scene/types.py:217-227), rounded as XLA
    fuses them inside the reference's frame (ops/fp.py)."""
    x = xf[:, None, :, :]                                     # (T, 1, 3, 4)
    q = p[:, :, None, :]                                      # (T, 3, 1, 3)
    return dot3(x[..., 0], q[..., 0], x[..., 1], q[..., 1],
                x[..., 2], q[..., 2]) + x[..., 3]


def build_scene(
    positions,
    normals,
    tri_vidx,
    prim_of_tri,
    materials: MaterialTable,
    instances,
    tangents=None,
    uvs=None,
    textures: Optional[TextureAtlas] = None,
    device="cuda",
) -> SceneBuffers:
    """Assemble SceneBuffers from host (numpy) mesh data, as
    sunray_tpu.scene.types.build_scene does, onto `device`.

    instances: list of (prim_id, (3, 4) transform)."""
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    tri_vidx = np.asarray(tri_vidx, np.int32)
    prim_of_tri = np.asarray(prim_of_tri, np.int32)
    v = positions.shape[0]
    if tangents is None:
        tangents = np.zeros((v, 4), np.float32)
    if uvs is None:
        uvs = np.zeros((v, NUM_TEX_SLOTS, 2), np.float32)

    inst_prim = np.asarray([p for p, _ in instances], np.int32)
    inst_xf = np.asarray([t for _, t in instances], np.float32).reshape(-1, 3, 4)

    w_vidx, w_inst = [], []
    for i, prim in enumerate(inst_prim):
        mask = prim_of_tri == prim
        w_vidx.append(tri_vidx[mask])
        w_inst.append(np.full(int(mask.sum()), i, np.int32))
    w_vidx = np.concatenate(w_vidx) if w_vidx else np.zeros((0, 3), np.int32)
    w_inst = np.concatenate(w_inst) if w_inst else np.zeros((0,), np.int32)

    # Emissive triangles (scene.rs:115-135): emission = factor.rgb * strength.
    ef = materials.emissive_factor.cpu().numpy()
    em_v, em_rgb, em_prim = [], [], []
    for prim in range(ef.shape[0]):
        strength_rgb = ef[prim, :3] * ef[prim, 3]
        if not np.any(strength_rgb != 0.0):
            continue
        tv = positions[tri_vidx[prim_of_tri == prim]]         # (n, 3, 3)
        for k in range(tv.shape[0]):
            em_v.append(tv[k])
            em_rgb.append(strength_rgb)
            em_prim.append(prim)
    em_v = np.asarray(em_v, np.float32).reshape(-1, 3, 3)
    em_rgb = np.asarray(em_rgb, np.float32).reshape(-1, 3)
    em_prim = np.asarray(em_prim, np.int32)

    # Light indirection (resource_manager.rs:216-267) and each light's
    # world-triangle id: an emissive primitive's k-th emissive triangle is
    # its k-th triangle, so world id = instance offset + k.
    inst_offset = np.zeros(len(inst_prim), np.int64)
    off = 0
    for i, prim in enumerate(inst_prim):
        inst_offset[i] = off
        off += int((prim_of_tri == prim).sum())
    lt, li, lw = [], [], []
    for i, prim in enumerate(inst_prim):
        idx = np.nonzero(em_prim == prim)[0]
        lt.append(idx.astype(np.int32))
        li.append(np.full(idx.shape[0], i, np.int32))
        k = idx - (idx[0] if idx.size else 0)
        lw.append((inst_offset[i] + k).astype(np.int32))
    lt = np.concatenate(lt) if lt else np.zeros((0,), np.int32)
    li = np.concatenate(li) if li else np.zeros((0,), np.int32)
    lw = np.concatenate(lw) if lw else np.zeros((0,), np.int32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return SceneBuffers(
        positions=t(positions),
        normals=t(normals),
        tangents=t(np.asarray(tangents, np.float32)),
        uvs=t(np.asarray(uvs, np.float32)),
        tri_vidx=t(w_vidx),
        tri_inst=t(w_inst),
        inst_transform=t(inst_xf),
        inst_prim=t(inst_prim),
        materials=_tensors_to(materials, device),
        textures=(_tensors_to(textures, device) if textures is not None
                  else TextureAtlas.empty(device)),
        emissive_v=t(em_v),
        emissive_rgb=t(em_rgb),
        emissive_prim=t(em_prim),
        light_tri=t(lt),
        light_inst=t(li),
        light_world_tri=t(lw),
    )


def identity_transform() -> np.ndarray:
    return np.concatenate(
        [np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)], axis=1
    )


def translate(x, y, z) -> np.ndarray:
    t = identity_transform()
    t[:, 3] = (x, y, z)
    return t
