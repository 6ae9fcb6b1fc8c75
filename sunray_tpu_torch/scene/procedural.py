"""Procedural scenes — port of the Cornell box of sunray_tpu/scene/procedural.py.

The same numpy mesh builder, assembled through the port's own build_scene
onto `device`.
"""

from __future__ import annotations

import numpy as np

from sunray_tpu_torch.scene.types import (
    MaterialTable,
    SceneBuffers,
    build_scene,
    identity_transform,
)


class _MeshBuilder:
    def __init__(self):
        self.positions = []
        self.normals = []
        self.tri_vidx = []
        self.prim_of_tri = []
        self.materials = []

    def add_material(self, **mat) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_quad(self, p0, p1, p2, p3, prim: int):
        """Two triangles for quad p0-p1-p2-p3 (counter-clockwise winding)."""
        p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
        n = np.cross(p1 - p0, p3 - p0)
        n = n / np.linalg.norm(n)
        base = len(self.positions)
        self.positions += [p0, p1, p2, p3]
        self.normals += [n] * 4
        self.tri_vidx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        self.prim_of_tri += [prim, prim]

    def add_box(self, center, size, prim: int, rotate_y: float = 0.0):
        cx, cy, cz = center
        sx, sy, sz = (s / 2.0 for s in size)
        corners = np.array(
            [
                [-sx, -sy, -sz], [sx, -sy, -sz], [sx, -sy, sz], [-sx, -sy, sz],
                [-sx, sy, -sz], [sx, sy, -sz], [sx, sy, sz], [-sx, sy, sz],
            ],
            np.float32,
        )
        if rotate_y:
            c, s = np.cos(rotate_y), np.sin(rotate_y)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            corners = corners @ rot.T
        corners += np.asarray(center, np.float32)
        b, t = corners[:4], corners[4:]
        # add_quad's normal is cross(p1-p0, p3-p0); order chosen so every
        # face normal points OUTWARD.
        self.add_quad(b[0], b[1], b[2], b[3], prim)   # bottom, normal -y
        self.add_quad(t[0], t[3], t[2], t[1], prim)   # top, normal +y
        self.add_quad(b[0], t[0], t[1], b[1], prim)   # -z side
        self.add_quad(b[1], t[1], t[2], b[2], prim)   # +x side
        self.add_quad(b[2], t[2], t[3], b[3], prim)   # +z side
        self.add_quad(b[3], t[3], t[0], b[0], prim)   # -x side

    def build(self, instances=None, device="cpu") -> SceneBuffers:
        if instances is None:
            # One identity instance per primitive that has triangles.
            prims = sorted(set(self.prim_of_tri))
            instances = [(p, identity_transform()) for p in prims]
        return build_scene(
            positions=np.asarray(self.positions, np.float32),
            normals=np.asarray(self.normals, np.float32),
            tri_vidx=np.asarray(self.tri_vidx, np.int32),
            prim_of_tri=np.asarray(self.prim_of_tri, np.int32),
            materials=MaterialTable.build(self.materials, device),
            instances=instances,
            device=device,
        )


def cornell_box(light_emission: float = 15.0, device="cpu") -> SceneBuffers:
    """The classic Cornell box in a [0,2]^3-ish volume, camera looking -z.

    Walls: white floor/ceiling/back, red left, green right; area light near
    the ceiling; two white boxes.
    """
    b = _MeshBuilder()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0)
    red = b.add_material(base_color=(0.65, 0.05, 0.05, 1.0), roughness=1.0)
    green = b.add_material(base_color=(0.12, 0.45, 0.15, 1.0), roughness=1.0)
    light = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0),
        emissive_factor=(1.0, 1.0, 1.0, light_emission),
        roughness=1.0,
    )

    s = 2.0  # box size
    # Floor (y=0, normal +y)
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), white)
    # Ceiling (y=s, normal -y)
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)
    # Back wall (z=0, normal +z)
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), white)
    # Left wall (x=0, normal +x) red
    b.add_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), red)
    # Right wall (x=s, normal -x) green
    b.add_quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0), green)
    # Area light, slightly below ceiling, facing down
    lx0, lx1 = 0.65 * s / 2.0, 1.35 * s / 2.0
    lz0, lz1 = 0.65 * s / 2.0, 1.35 * s / 2.0
    ly = s - 0.01
    # Wind so the light normal faces DOWN into the box.
    b.add_quad((lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1), light)
    # Two boxes
    b.add_box((0.65, 0.6, 0.65), (0.6, 1.2, 0.6), white, rotate_y=np.deg2rad(18.0))
    b.add_box((1.4, 0.3, 1.3), (0.6, 0.6, 0.6), white, rotate_y=np.deg2rad(-17.0))
    return b.build(device=device)
