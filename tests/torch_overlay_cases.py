"""Seeded 2D meshes for the overlay painter's tests (no JAX): numpy arrays
that tests/test_torch_overlay.py hands to the JAX package and the port,
and that the card tests and chip_smoke.py phase 14 hand to R1 and its
plain twin.

stress_meshes(h, w, n_tris, seed): four meshes over an (h, w) image:
  - "soup": overlapping triangles of both windings with random vertex
    colours, a tenth of them degenerate (a repeated vertex, three
    collinear points, or an area below 1e-8);
  - "textured": the same kind of triangles with random uv into a random
    (9, 13, 4) texture;
  - "clipped": triangles under a clip rect with fractional bounds;
  - "panel": a quad over most of the frame, alpha 0.4.
"""

import numpy as np


def _triangles(g, n, h, w, degenerate=0.1):
    """(3n, 2) float32 vertices of n triangles that overlap the frame and
    each other; both windings; a share of them degenerate."""
    centre = g.random((n, 1, 2)) * np.array([w, h]) * 1.2 - \
        0.1 * np.array([w, h])
    size = np.exp(g.uniform(np.log(2.0), np.log(0.4 * min(h, w)), (n, 1, 1)))
    xy = centre + g.normal(0.0, 1.0, (n, 3, 2)) * size
    # The first share of the triangles is degenerate, kinds in turn (the
    # mesh's triangle order is shuffled afterwards).
    k = np.arange(n)
    dg = k < max(3, int(round(degenerate * n)))
    rep, col, tiny = dg & (k % 3 == 0), dg & (k % 3 == 1), dg & (k % 3 == 2)
    xy[rep, 2] = xy[rep, 0]                                  # repeated vertex
    xy[col, 2] = xy[col, 0] + 2.5 * (xy[col, 1] - xy[col, 0])  # collinear
    xy[tiny, 1] = xy[tiny, 0] + np.array([1e-5, 0.0])
    xy[tiny, 2] = xy[tiny, 0] + np.array([0.0, 1e-5])       # area ~5e-11
    flip = g.random(n) < 0.5
    xy[flip] = xy[flip][:, ::-1]                             # other winding
    return xy.reshape(-1, 2).astype(np.float32)


def mesh_arrays(g, n, h, w, textured=False, clip=None, degenerate=0.1):
    xy = _triangles(g, n, h, w, degenerate)
    v = xy.shape[0]
    rgba = g.random((v, 4)).astype(np.float32)
    rgba[:, 3] = g.uniform(0.3, 1.0, v)
    uv = (g.random((v, 2)) if textured else np.zeros((v, 2))).astype(np.float32)
    tris = np.arange(v, dtype=np.int32).reshape(-1, 3)
    tris = tris[g.permutation(len(tris))]
    tex = g.random((9, 13, 4)).astype(np.float32) if textured else None
    return dict(xy=xy, uv=uv, rgba=rgba, tris=tris, tex=tex, clip=clip)


def stress_meshes(h, w, n_tris, seed):
    """Four meshes (dicts of numpy arrays) with n_tris triangles in all."""
    g = np.random.default_rng(seed)
    n = max(n_tris // 3, 1)
    panel = dict(
        xy=np.array([[0.1 * w, 0.2 * h], [0.9 * w, 0.2 * h],
                     [0.9 * w, 0.85 * h], [0.1 * w, 0.85 * h]], np.float32),
        uv=np.zeros((4, 2), np.float32),
        rgba=np.tile(np.array([[0.2, 0.3, 0.9, 0.4]], np.float32), (4, 1)),
        tris=np.array([[0, 1, 2], [0, 2, 3]], np.int32), tex=None, clip=None)
    clip = (0.21 * w + 0.3, 0.33 * h + 0.7, 0.77 * w + 0.1, 0.9 * h + 0.4)
    return [
        mesh_arrays(g, n, h, w),
        mesh_arrays(g, n, h, w, textured=True),
        mesh_arrays(g, max(n_tris - 2 * n - 2, 1), h, w, clip=clip),
        panel,
    ]


def seeded_image(h, w, seed):
    g = np.random.default_rng(seed)
    return g.random((h, w, 3)).astype(np.float32)


HUD_LINES = ["FPS 59.94", "FRAME 00042", "RAYS 6.2M/S", "SPP 1 (RESTIR)"]


def frame_times(n, seed):
    g = np.random.default_rng(seed)
    return list(16.0 + 3.0 * np.sin(np.arange(n) / 7.0) + g.normal(0, 0.8, n))
