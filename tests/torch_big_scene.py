"""The big-mesh scene of the port's binned-tracer tests: the Cornell box with
one mirror icosphere resting on the short box.

numpy only (no torch, no JAX): big_scene_args() returns the keyword
arguments of build_scene, with the material records in "materials", so
that each package turns the identical arrays into its own scene:

    args = big_scene_args(subdiv)
    build_scene(**dict(args, materials=MaterialTable.build(args["materials"])))

The box is built by the same calls as the Cornell box of
sunray_tpu/scene/procedural.py:83-120; the sphere is the icosphere of
examples/bench_instances.py:24-63. At subdiv=6 it has 81,920 triangles
(81,956 in all: 641 clusters of 128, 161 superclusters of 4), the mesh
the JAX package's binned tracer was measured on.
"""

import numpy as np

SPHERE_CENTER = (1.4, 0.9, 1.3)     # on the short box (top at y = 0.6)
SPHERE_RADIUS = 0.3
MIRROR = dict(base_color=(0.95, 0.95, 0.95, 1.0), metallic=1.0,
              roughness=0.05)


def icosphere(subdiv):
    """Icosahedron subdivided `subdiv` times -> (V, 3) unit vertices,
    (T, 3) faces (examples/bench_instances.py:24-63)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float32,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int32,
    )
    for _ in range(subdiv):
        cache = {}
        verts = list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts, np.float32)
        f = np.asarray(nf, np.int32)
    return v, f


class _Mesh:
    """numpy twin of procedural._MeshBuilder (add_quad, add_box)."""

    def __init__(self):
        self.positions, self.normals = [], []
        self.tri_vidx, self.prim_of_tri, self.materials = [], [], []

    def add_material(self, **mat):
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_quad(self, p0, p1, p2, p3, prim):
        p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
        n = np.cross(p1 - p0, p3 - p0)
        n = n / np.linalg.norm(n)
        base = len(self.positions)
        self.positions += [p0, p1, p2, p3]
        self.normals += [n] * 4
        self.tri_vidx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        self.prim_of_tri += [prim, prim]

    def add_box(self, center, size, prim, rotate_y=0.0):
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
        self.add_quad(b[0], b[1], b[2], b[3], prim)
        self.add_quad(t[0], t[3], t[2], t[1], prim)
        self.add_quad(b[0], t[0], t[1], b[1], prim)
        self.add_quad(b[1], t[1], t[2], b[2], prim)
        self.add_quad(b[2], t[2], t[3], b[3], prim)
        self.add_quad(b[3], t[3], t[0], b[0], prim)


def big_scene_args(subdiv=6, light_emission=15.0):
    """build_scene keyword arguments of the Cornell box plus one mirror
    icosphere instance (scale 0.3, centre SPHERE_CENTER); "materials" holds
    the material records."""
    b = _Mesh()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0)
    red = b.add_material(base_color=(0.65, 0.05, 0.05, 1.0), roughness=1.0)
    green = b.add_material(base_color=(0.12, 0.45, 0.15, 1.0), roughness=1.0)
    light = b.add_material(
        base_color=(1.0, 1.0, 1.0, 1.0),
        emissive_factor=(1.0, 1.0, 1.0, light_emission),
        roughness=1.0,
    )
    s = 2.0
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), white)
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), white)
    b.add_quad((0, 0, 0), (0, s, 0), (0, s, s), (0, 0, s), red)
    b.add_quad((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0), green)
    lx0, lx1 = 0.65 * s / 2.0, 1.35 * s / 2.0
    lz0, lz1 = 0.65 * s / 2.0, 1.35 * s / 2.0
    ly = s - 0.01
    b.add_quad((lx0, ly, lz0), (lx1, ly, lz0), (lx1, ly, lz1), (lx0, ly, lz1),
               light)
    b.add_box((0.65, 0.6, 0.65), (0.6, 1.2, 0.6), white,
              rotate_y=np.deg2rad(18.0))
    b.add_box((1.4, 0.3, 1.3), (0.6, 0.6, 0.6), white,
              rotate_y=np.deg2rad(-17.0))

    mirror = b.add_material(**MIRROR)
    verts, faces = icosphere(subdiv)
    base = len(b.positions)
    positions = np.concatenate([np.asarray(b.positions, np.float32), verts])
    normals = np.concatenate([np.asarray(b.normals, np.float32), verts])
    tri_vidx = np.concatenate([np.asarray(b.tri_vidx, np.int32), faces + base])
    prim_of_tri = np.concatenate([np.asarray(b.prim_of_tri, np.int32),
                                  np.full(faces.shape[0], mirror, np.int32)])

    identity = np.concatenate([np.eye(3, dtype=np.float32),
                               np.zeros((3, 1), np.float32)], axis=1)
    sphere_xf = np.concatenate(
        [np.eye(3, dtype=np.float32) * SPHERE_RADIUS,
         np.asarray(SPHERE_CENTER, np.float32)[:, None]], axis=1)
    instances = [(p, identity) for p in sorted(set(b.prim_of_tri))]
    instances.append((mirror, sphere_xf))
    return dict(positions=positions, normals=normals, tri_vidx=tri_vidx,
                prim_of_tri=prim_of_tri, materials=b.materials,
                instances=instances)
