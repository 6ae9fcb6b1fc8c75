"""Shared inputs of the BVH tests of the PyTorch port (tests/test_torch_bvh*.py):
a seeded triangle soup with a flat floor grid, and the ray families the
walks are held to JAX on. numpy only; no JAX, no torch."""

import numpy as np


def soup(t=300, seed=0, floor=6):
    """(v0, v1, v2) float32 (T, 3): t random triangles over [-2, 2]^3 and a
    floor x floor grid of quads (2 floor^2 triangles) at y = -2.5."""
    g = np.random.default_rng(seed)
    c = g.uniform(-2, 2, (t, 3)).astype(np.float32)
    e1 = (g.normal(size=(t, 3)) * 0.3).astype(np.float32)
    e2 = (g.normal(size=(t, 3)) * 0.3).astype(np.float32)
    vs = [c, c + e1, c + e2]
    xs = np.linspace(-3, 3, floor + 1, dtype=np.float32)
    quads = []
    for i in range(floor):
        for j in range(floor):
            a = (xs[i], -2.5, xs[j])
            b = (xs[i + 1], -2.5, xs[j])
            cc = (xs[i + 1], -2.5, xs[j + 1])
            d = (xs[i], -2.5, xs[j + 1])
            quads += [(a, b, cc), (a, cc, d)]
    q = np.asarray(quads, np.float32).reshape(-1, 3, 3)
    return tuple(np.concatenate([v, q[:, k]]) for k, v in enumerate(vs))


def _unit(d):
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def ray_families(tris, n=512, seed=1):
    """{name: (orig (N, 3), dir (N, 3))}: camera rays from one point,
    bounce rays leaving triangle points, rays grazing the floor, and
    axis-parallel rays (two zero direction components)."""
    g = np.random.default_rng(seed)
    v0, v1, v2 = tris
    out = {}
    tgt = g.uniform(-3, 3, (n, 3)).astype(np.float32)
    eye = np.tile(np.float32([0.3, 0.5, 6.0]), (n, 1))
    out["camera"] = (eye, _unit(tgt - eye))
    k = g.integers(0, v0.shape[0], n)
    a, b = g.random(n), g.random(n)
    flip = a + b > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    p = (v0[k] + a[:, None] * (v1[k] - v0[k]) + b[:, None] * (v2[k] - v0[k]))
    out["bounce"] = (p.astype(np.float32), _unit(g.normal(size=(n, 3))))
    o = np.stack([g.uniform(-4, 4, n), np.full(n, -2.45),
                  g.uniform(-4, 4, n)], 1).astype(np.float32)
    d = np.stack([g.normal(size=n), -g.uniform(1e-4, 2e-2, n),
                  g.normal(size=n)], 1)
    out["grazing"] = (o, _unit(d))
    axis = g.integers(0, 3, n)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = np.where(g.random(n) < 0.5, -1.0, 1.0)
    out["axis"] = (g.uniform(-3, 3, (n, 3)).astype(np.float32), d)
    return out


# -- alpha-cutout scenes (tests/test_torch_bvh_alpha.py, the card tests) ------
# Each is a dict of build_scene's arguments as numpy arrays and lists (the
# atlas as (data, size, wrap, filt)); scene/types.py's ALPHA_MASK = 1,
# WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR = 0, 1, 2, NULL_TEXTURE = -1.

def _identity():
    return np.concatenate([np.eye(3, dtype=np.float32),
                           np.zeros((3, 1), np.float32)], 1)


def _quads(quads):
    """(positions, tri_vidx, prim) of [(corners (4, 3), prim)] quads."""
    pos, tris, prim = [], [], []
    for corners, p in quads:
        b = len(pos)
        pos += list(corners)
        tris += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        prim += [p, p]
    return (np.asarray(pos, np.float32), np.asarray(tris, np.int32),
            np.asarray(prim, np.int32))


def tunnel_arrays(layers=6):
    """`layers` checker cutout quads with one 4x4 texture and the same uvs,
    one behind the other, in front of an opaque back quad: a ray through
    a hole passes every layer."""
    quads = []
    for k in range(layers + 1):
        s, z = (2.0 if k == layers else 1.0), float(layers - k)
        quads.append(([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]],
                      0 if k < layers else 1))
    pos, tris, prim = _quads(quads)
    uvs = np.zeros((pos.shape[0], 5, 2), np.float32)
    uvs[:] = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]] * (layers + 1))[:, None]
    tex = np.ones((1, 4, 4, 4), np.float32)
    tex[0, :, :, 3] = np.add.outer(np.arange(4), np.arange(4)) % 2
    return dict(
        positions=pos, tri_vidx=tris, prim_of_tri=prim, uvs=uvs,
        records=[{"alpha_mode": 1, "alpha_cutoff": 0.5,
                  "tex_index": [0, -1, -1, -1, -1]}, {}],
        instances=[(0, _identity()), (1, _identity())],
        atlas=(tex, np.int32([[4, 4]]), np.zeros((1, 2), np.int32),
               np.zeros((1,), np.int32)))


def wraps_arrays(seed=5):
    """Eight MASK quads in a row: six textures, each with its own size,
    wrap mode per axis (repeat, clamp, mirror) and filter (nearest,
    bilinear), uvs from -2.3 to 3.4 (negative texel coordinates), and two
    NULL_TEXTURE materials, one below and one above the cutoff; a second
    instance of each quad 0.5 behind and shifted; an opaque back wall."""
    g = np.random.default_rng(seed)
    modes = [(0, 1, 0), (1, 2, 1), (2, 0, 0), (0, 2, 1), (1, 0, 1), (2, 1, 0)]
    sizes = [(5, 3), (7, 6), (4, 8), (8, 5), (3, 7), (6, 4)]
    tex = np.zeros((len(modes), 8, 8, 4), np.float32)
    for k, (w, h) in enumerate(sizes):
        tex[k, :h, :w] = g.random((h, w, 4))
    recs = [{"alpha_mode": 1, "alpha_cutoff": 0.5,
             "tex_index": [k, -1, -1, -1, -1]} for k in range(len(modes))]
    recs += [{"alpha_mode": 1, "alpha_cutoff": 0.5,
              "base_color": (0.5, 0.5, 0.5, a)} for a in (0.3, 0.7)]
    recs.append({"base_color": (0.5, 0.5, 0.5, 1.0)})
    last = len(recs) - 1
    quads = [([[-4.0 + k, -0.5, 0], [-3.0 + k, -0.5, 0], [-3.0 + k, 0.5, 0],
               [-4.0 + k, 0.5, 0]], k) for k in range(last)]
    quads.append(([[-6, -6, -2], [6, -6, -2], [6, 6, -2], [-6, 6, -2]], last))
    pos, tris, prim = _quads(quads)
    uvs = np.zeros((pos.shape[0], 5, 2), np.float32)
    uvs[:] = np.float32([[-2.3, -1.9], [3.4, -2.2], [3.1, 2.9],
                         [-1.7, 3.3]] * len(quads))[:, None]
    behind = _identity()
    behind[:, 3] = (0.37, 0.11, -0.5)
    inst = ([(k, _identity()) for k in range(last)]
            + [(k, behind) for k in range(last)] + [(last, _identity())])
    return dict(
        positions=pos, tri_vidx=tris, prim_of_tri=prim, uvs=uvs,
        records=recs, instances=inst,
        atlas=(tex, np.int32(sizes), np.int32([m[:2] for m in modes]),
               np.int32([m[2] for m in modes])))


def alpha_scene_rays(which, count=600, seed=0, camera=None):
    """(orig, dir, tmax) float32 rays through the cutouts of "tunnel",
    "wraps", "layered" (tests/test_torch_alpha.py's layers) or "glb"
    (tools/synth_gltf.py's MASK panel grid at z = 2.6, seen from
    `camera`, its CAMERA position)."""
    g = np.random.default_rng(seed)
    if which == "glb":
        o = np.tile(np.float32(camera), (count, 1))
        tgt = np.stack([g.uniform(0.1, 1.8, count), g.uniform(0.0, 1.6, count),
                        np.full(count, 2.6)], 1)
        d = tgt - o
        tmax = g.uniform(3.0, 12.0, count)
    else:
        half, high = (4.3, 0.6) if which == "wraps" else (1.2, 1.2)
        o = np.stack([g.uniform(-half, half, count),
                      g.uniform(-high, high, count), np.full(count, 8.0)], 1)
        d = np.tile(np.float64([[0.0, 0.0, -1.0]]), (count, 1))
        d[::3, 0] = 0.05
        d[1::4, 1] = -0.03
        tmax = g.uniform(2.0, 10.5, count)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)
