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
