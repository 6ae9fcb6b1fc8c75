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

adversarial_sets(h, w, seed): {name: (image, meshes)}, the inputs that
make R1's tile binning subtle (csrc/overlay.cu's note): triangles whose
edge functions are all rounding, coordinates whose products overflow or
are not finite, edges through pixel centres, meshes that cover nothing,
and words whose sign or NaN an uncovered pixel must keep as the plain
twin does.
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


# -- adversarial sets ---------------------------------------------------------

def _f32_area(xy):
    """(n,) float32 areas of (n, 3, 2) float32 triangles, rounded as the
    kernel and the plain twin round them: fma(x1 - x0, y2 - y0, -((x2 - x0)
    * (y1 - y0))) (one float64 sum of an exact product, then float32)."""
    d = lambda a, b: (xy[:, a] - xy[:, b]).astype(np.float32)
    a, b = d(1, 0), d(2, 0)
    q = (b[:, 0] * a[:, 1]).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        return (a[:, 0].astype(np.float64) * b[:, 1] - q).astype(np.float32)


def _mesh(g, xy, tex=None, clip=None, rgba=None):
    """A mesh dict of the (n, 3, 2) triangles `xy`, random colours (alpha
    0.3-1) and, with a texture, random uv."""
    xy = np.asarray(xy, np.float32).reshape(-1, 2)
    v = xy.shape[0]
    if rgba is None:
        rgba = g.random((v, 4)).astype(np.float32)
        rgba[:, 3] = g.uniform(0.3, 1.0, v)
    uv = (g.random((v, 2)) if tex is not None else np.zeros((v, 2)))
    return dict(xy=xy, uv=uv.astype(np.float32),
                rgba=np.asarray(rgba, np.float32),
                tris=np.arange(v, dtype=np.int32).reshape(-1, 3), tex=tex,
                clip=clip)


def _centres(g, n, h, w):
    """(n, 2) random pixel centres of the image."""
    return np.stack([g.integers(0, w, n), g.integers(0, h, n)], 1) + 0.5


def _cover(g, h, w):
    """Two triangles over the whole image and a few ordinary ones: a mesh
    that covers pixels around its adversarial triangles."""
    return np.concatenate([
        np.array([[[-1, -1], [w + 1, -1], [w + 1, h + 1]],
                  [[-1, -1], [w + 1, h + 1], [-1, h + 1]]], np.float32),
        _triangles(g, 6, h, w, degenerate=0.0).reshape(-1, 3, 2)])


def _collinear(g, h, w):
    """Collinear triangles (xy2 = xy0 + 2.5 (xy1 - xy0)) whose float32
    area passes 1e-8. Half are random; half start on a pixel centre with a
    direction of whole pixels, the third vertex an ulp off the line, so the
    line runs through pixel centres beyond the triangle."""
    n = 200
    v0 = np.concatenate([g.random((n, 2)) * [w, h], _centres(g, n, h, w)])
    d = np.concatenate([g.normal(0, 0.2 * min(h, w), (n, 2)),
                        g.choice([-2, -1, 1, 2], (n, 2))
                        * g.integers(1, 6, (n, 1))])
    xy = np.stack([v0, v0 + d, v0 + 2.5 * d], 1).astype(np.float32)
    xy[n:, 2, 0] = np.nextafter(xy[n:, 2, 0], np.float32(np.inf))
    keep = np.abs(_f32_area(xy)) > np.float32(1e-8)
    xy = np.concatenate([xy[:n][keep[:n]][:30], xy[n:][keep[n:]][:30]])
    return [_mesh(g, xy), _mesh(g, np.concatenate([xy[:20], _cover(g, h, w),
                                                   xy[20:]]))]


def _needles(g, h, w):
    """Needles one ulp wide: the third vertex one ulp from the second, in x
    or in y; the first on a pixel centre for half of them, and a quarter
    each with the second on the first's row or column. The second mesh's
    needles were made near 4096 (an ulp of 2^-11) and moved over the frame
    exactly."""
    n = 24

    def make(base):
        v0 = g.random((n, 2)) * [w, h] + base
        v0[: n // 2] = np.floor(v0[: n // 2]) + 0.5
        d = g.normal(0, 0.3 * max(h, w), (n, 2))
        d[::4, 1] = 0.0
        d[1::4, 0] = 0.0
        v1 = (v0 + d).astype(np.float32)
        v2 = v1.copy()
        k, axis = np.arange(n), np.arange(n) % 2
        v2[k, axis] = np.nextafter(v1[k, axis], np.float32(np.inf))
        return np.stack([v0.astype(np.float32), v1, v2], 1)

    small = make(0.0)
    wide = make(4096.0) - np.float32(4096.0)
    return [_mesh(g, small),
            _mesh(g, np.concatenate([_cover(g, h, w), wide, small]))]


def _far(g, h, w):
    """Vertices at +-1e6 and +-1e30 beside vertices in the frame: huge
    triangles that cover the image, ones whose products overflow."""
    out = []
    for far in (1e6, 1e30):
        c = g.random((12, 2)) * [w, h]
        xy = np.zeros((12, 3, 2))
        xy[:, 0] = c
        xy[:, 1] = c + g.choice([-far, far], (12, 2))
        xy[:, 2] = c + g.normal(0, 0.3 * min(h, w), (12, 2))
        xy[:4, 2] = g.choice([-far, far], (4, 2))
        xy[4] = [[-far, -far], [far, -far], [0.0, far]]
        out.append(_mesh(g, xy))
    return out


def _nonfinite(g, h, w, value):
    """A vertex at `value` (+-inf or NaN) in x or y beside vertices in the
    frame."""
    c = g.random((16, 2)) * [w, h]
    xy = np.stack([c, c + g.normal(0, 0.3 * min(h, w), (16, 2)),
                   c + g.normal(0, 0.3 * min(h, w), (16, 2))], 1)
    k = np.arange(16)
    sign = np.where(k % 2 == 0, 1.0, -1.0) if np.isinf(value) else 1.0
    xy[k, k % 3, (k // 3) % 2] = sign * value
    return [_mesh(g, xy), _mesh(g, np.concatenate([_cover(g, h, w), xy]))]


def _pixel_centres(g, h, w):
    """Vertices on pixel centres: axis-aligned and diagonal edges (slopes
    1, 2 and 1/2) run through pixel centres; both windings."""
    xy = []
    for _ in range(24):
        a = _centres(g, 1, h, w)[0]
        s = g.integers(2, max(3, min(h, w) // 3))
        kind = g.integers(0, 4)
        if kind == 0:
            tri = [a, a + [s, 0], a + [0, s]]
        elif kind == 1:
            tri = [a, a + [s, s], a + [0, s]]
        elif kind == 2:
            tri = [a, a + [2 * s, s], a + [s, 2 * s]]
        else:
            tri = [a, a + [s, 0], a + [s, s]]
        tri = np.asarray(tri, np.float64)
        xy.append(tri[::-1] if g.random() < 0.5 else tri)
    return [_mesh(g, xy)]


def _off_image(g, h, w):
    """A mesh wholly off the image (each side), then one over it."""
    xy = _triangles(g, 20, h, w, degenerate=0.0).reshape(-1, 3, 2)
    xy = xy - xy.min(1, keepdims=True)
    side = np.arange(20) % 4
    xy[side == 0] += [-3.0 * w, 0.0]
    xy[side == 1] += [2.0 * w, 0.0]
    xy[side == 2] += [0.0, -3.0 * h]
    xy[side == 3] += [0.0, 2.0 * h]
    tex = g.random((5, 6, 4)).astype(np.float32)
    return [_mesh(g, xy), _mesh(g, xy, tex=tex),
            _mesh(g, _triangles(g, 10, h, w).reshape(-1, 3, 2))]


def _texels(g, value):
    """Textures (9, 13, 4) with `value` in one channel of one of the four
    texels the fetch at uv (0, 0) reads, or beside them; and 1 x 1."""
    out = []
    for r, c in ((0, 0), (0, 1), (1, 0), (1, 1), (2, 2)):
        tex = g.random((9, 13, 4)).astype(np.float32)
        tex[r, c, g.integers(0, 4)] = value
        out.append(tex)
    out.append(np.full((1, 1, 4), value, np.float32))
    return out


def _left(g, n, h, w):
    """(n, 3, 2) triangles with every vertex in the left third of the
    image: tiles further right meet none of them."""
    return g.random((n, 3, 2)) * [w / 3.0, h]


def _bad_texels(g, h, w, value, other):
    """Meshes over the left of the image (tiles on the right meet none)
    with `value` among the uv-(0, 0) texels, then one with `other` there
    (a NaN of another payload on the CPU)."""
    texs = _texels(g, value) + _texels(g, other)[-1:]
    return [_mesh(g, _left(g, 8, h, w), tex=tex) for tex in texs]


def _negative_colours(g, h, w):
    """Vertex colours below 0 and -0.0 words, alpha among them; one mesh
    clipped."""
    meshes = []
    for clip in (None, (0.2 * w, 0.1 * h, 0.7 * w + 0.5, 0.8 * h)):
        xy = _triangles(g, 30, h, w).reshape(-1, 3, 2)
        rgba = g.normal(0, 1, (90, 4)).astype(np.float32)
        rgba[g.random((90, 4)) < 0.2] = -0.0
        meshes.append(_mesh(g, xy, rgba=rgba, clip=clip))
    return meshes


def _many(g, h, w):
    """40 small meshes: quads and triangles a few pixels wide, a third of
    them textured, a fifth clipped."""
    meshes = []
    for i in range(40):
        c = g.random(2) * [w, h]
        xy = c + g.normal(0, 3.0, (int(g.integers(1, 5)), 3, 2))
        tex = g.random((3, 4, 4)).astype(np.float32) if i % 3 == 0 else None
        clip = ((c[0] - 2.0, c[1] - 2.0, c[0] + 1.5, c[1] + 2.5)
                if i % 5 == 0 else None)
        meshes.append(_mesh(g, xy, tex=tex, clip=clip))
    return meshes


def _negzero_meshes(g, h, w):
    """Over an image of -0.0 words: an untextured mesh (an uncovered pixel
    adds +0, so its words turn +0) and textured ones whose uv-(0, 0)
    texels are negative or -0.0 (they add -0, so the words stay -0); all
    over the left of the image."""
    tri = lambda: _left(g, 6, h, w)
    neg = -g.random((4, 5, 4)).astype(np.float32)
    zero = np.full((2, 2, 4), -0.0, np.float32)
    return [_mesh(g, tri()), _mesh(g, tri(), tex=neg), _mesh(g, tri(), tex=zero)]


ADVERSARIAL = {
    "collinear": _collinear,
    "needles": _needles,
    "far": _far,
    "inf_vertex": lambda g, h, w: _nonfinite(g, h, w, np.inf),
    "nan_vertex": lambda g, h, w: _nonfinite(g, h, w, np.nan),
    "pixel_centres": _pixel_centres,
    "off_image": _off_image,
    "negzero_image": lambda g, h, w: _negzero_meshes(g, h, w),
    "nan_texel": lambda g, h, w: _bad_texels(g, h, w, np.nan, np.inf),
    "inf_texel": lambda g, h, w: _bad_texels(g, h, w, np.inf, np.nan),
    "negative_colours": _negative_colours,
    "many_meshes": _many,
}


def adversarial_set(name, h, w, seed):
    """(image, meshes) of the named adversarial set on an (h, w) image: a
    seeded image with a third of its words -0.0 (every word for
    "negzero_image"), so that what an uncovered pixel adds shows, and the
    set's meshes (dicts of numpy arrays)."""
    g = np.random.default_rng([seed, list(ADVERSARIAL).index(name)])
    meshes = ADVERSARIAL[name](g, h, w)
    img = seeded_image(h, w, int(g.integers(1 << 30)))
    img[g.random((h, w, 3)) < 1 / 3] = -0.0
    if name == "negzero_image":
        img[:] = -0.0
    return img, meshes
