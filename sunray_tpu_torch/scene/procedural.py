"""Procedural scenes — port of the Cornell box, its many-lights variant and
the reflection room of sunray_tpu/scene/procedural.py.

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

    def build(self, instances=None, device="cuda") -> SceneBuffers:
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


def cornell_box(light_emission: float = 15.0, device="cuda") -> SceneBuffers:
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


def cornell_box_many_lights(panels: int = 12, light_emission: float = 15.0,
                            device="cuda") -> SceneBuffers:
    """The Cornell box with its area light replaced by a panels x panels
    grid of small ceiling emitters, 2 * panels^2 light triangles (12 ->
    288, 17 -> 578): the many-light audition case (procedural.py:122-169).
    Each panel's emission is scaled by the grid's fill factor, so the
    total power is the single light's."""
    b = _MeshBuilder()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0)
    red = b.add_material(base_color=(0.65, 0.05, 0.05, 1.0), roughness=1.0)
    green = b.add_material(base_color=(0.12, 0.45, 0.15, 1.0), roughness=1.0)

    s = 2.0
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), white)
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), white)
    b.add_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), red)
    b.add_quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0), green)

    lx0, lx1 = 0.65 * s / 2.0, 1.35 * s / 2.0
    ly = s - 0.01
    cell = (lx1 - lx0) / panels
    fill = 0.6                      # panel side / cell side
    scale = 1.0 / (fill * fill)     # keep the total power the single light's
    light = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0),
        emissive_factor=(1.0, 1.0, 1.0, light_emission * scale),
        roughness=1.0,
    )
    half = 0.5 * fill * cell
    for i in range(panels):
        for j in range(panels):
            cx = lx0 + (i + 0.5) * cell
            cz = lx0 + (j + 0.5) * cell
            b.add_quad(
                (cx - half, ly, cz - half), (cx + half, ly, cz - half),
                (cx + half, ly, cz + half), (cx - half, ly, cz + half),
                light,
            )

    b.add_box((0.65, 0.6, 0.65), (0.6, 1.2, 0.6), white,
              rotate_y=np.deg2rad(18.0))
    b.add_box((1.4, 0.3, 1.3), (0.6, 0.6, 0.6), white,
              rotate_y=np.deg2rad(-17.0))
    return b.build(device=device)


def reflection_room(light_emission: float = 12.0, device="cuda") -> SceneBuffers:
    """Room with a mirror wall, a glass box and an area light
    (procedural.py:173-210): the mirror (metallic > 0.9, roughness < 0.1)
    and transmissive passthrough paths of ray_gen_ris.slang:95-117."""
    b = _MeshBuilder()
    white = b.add_material(base_color=(0.7, 0.7, 0.7, 1.0), roughness=0.9)
    blue = b.add_material(base_color=(0.2, 0.3, 0.7, 1.0), roughness=0.6)
    mirror = b.add_material(
        base_color=(0.95, 0.95, 0.95, 1.0), metallic=1.0, roughness=0.02
    )
    glass = b.add_material(
        base_color=(0.95, 0.95, 0.98, 1.0), roughness=0.02, transmission=1.0,
        ior=1.5,
    )
    light = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0),
        emissive_factor=(1.0, 0.95, 0.9, light_emission),
    )

    s = 4.0
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), white)       # floor
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)       # ceiling
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), mirror)      # back = mirror
    b.add_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), blue)        # left
    b.add_quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0), blue)        # right
    ly = s - 0.02
    # Wound so the light normal faces DOWN into the room.
    b.add_quad(
        (s * 0.35, ly, s * 0.35), (s * 0.65, ly, s * 0.35),
        (s * 0.65, ly, s * 0.65), (s * 0.35, ly, s * 0.65), light,
    )
    b.add_box((s * 0.3, 0.5, s * 0.55), (1.0, 1.0, 1.0), glass)
    b.add_box((s * 0.7, 0.4, s * 0.35), (0.8, 0.8, 0.8), white, rotate_y=0.5)
    return b.build(device=device)
