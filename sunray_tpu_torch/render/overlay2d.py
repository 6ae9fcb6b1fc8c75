"""egui-class 2D overlay painter — port of sunray_tpu/render/overlay2d.py.

The reference's egui raster backend (bevy_integration/egui_paint.rs:
1-425) draws egui's tessellated output, clipped triangle meshes with
vertex colour and uv into small RGBA textures, over the path-traced
frame with scissor rects and alpha blending. This module is the painter:

  - `Mesh2D`: one clipped primitive: (V, 2) pixel positions, (V, 2) uv,
    (V, 4) straight-alpha vertex RGBA, (T, 3) indices, an optional
    (TH, TW, 4) texture and an optional scissor rect (x0, y0, x1, y1).
  - `rasterize_mesh`: one mesh to (rgb, alpha) planes: for each
    triangle in order, edge-function coverage (either winding) and
    barycentric uv and colour; the last covering triangle wins; then one
    bilinear texture fetch and the clip rect.
  - `paint_meshes`: meshes blended back to front in submission order.
    On the card it is R1 (ops/cuda_overlay.py, csrc/overlay.cu): one
    launch for every mesh. On the CPU it is `paint_meshes_plain`, the
    kernel's plain twin and yardstick.
  - Tessellators (host numpy, as in the reference package): `tess_rect`
    (rounded corners as corner fans), `tess_polyline` / `tess_line`
    (quad strips), `tess_text` (textured glyph quads into `font_atlas`),
    `plot_lines` and `hud_overlay`. They build meshes on the CPU;
    `paint_meshes` moves them to the image's device.
  - Host numpy helpers for interactive loops (`_np_blend_rect`,
    `_np_text`, `_np_polyline`, `hud_overlay_np`), arithmetic as in the
    reference package.

Roundings. The reference runs the triangle loop as a lax.scan, so XLA's
CPU backend compiles its body as one computation and contracts some
multiply-adds; the rest (texture fetch, clip, blend) runs as eager jnp
ops, each rounded on its own. Read off the reference (pinned against
its compiled scan in tests/test_torch_overlay.py):

  area = fma(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)))
  e0   = fma(x2 - x1, py - y1, -((y2 - y1) * (px - x1))) * s   (e1, e2 alike)
  attr = fma(w2, a2, fma(w0, a0, w1 * a1))                     (uv, colour)

with s = -1 for a negative area, else 1, w_i = e_i * inv * s and
inv = s / max(|area|, 1e-8). csrc/overlay.cu calls fmaf() at exactly
these places.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.render.overlay import (_GLYPHS, GLYPH_H, GLYPH_W,
                                             _glyph_mask)

_F32 = torch.float32
_EPS = np.float32(1e-8)


class Mesh2D(NamedTuple):
    xy: torch.Tensor              # (V, 2) f32 pixel coords (x right, y down)
    uv: torch.Tensor              # (V, 2) f32 in [0, 1] (ignored if tex None)
    rgba: torch.Tensor            # (V, 4) f32 straight alpha
    tris: torch.Tensor            # (T, 3) int32
    tex: Optional[torch.Tensor] = None    # (TH, TW, 4) f32 or None
    clip: Optional[tuple] = None          # (x0, y0, x1, y1) or None


def mesh_to(mesh: Mesh2D, device) -> Mesh2D:
    """The mesh with its tensors on `device`."""
    return mesh._replace(
        xy=mesh.xy.to(device), uv=mesh.uv.to(device),
        rgba=mesh.rgba.to(device), tris=mesh.tris.to(device),
        tex=None if mesh.tex is None else mesh.tex.to(device))


def tri_data(mesh: Mesh2D) -> torch.Tensor:
    """(T, 24) float32: each triangle's three positions, uvs and colours."""
    t = mesh.tris.long()
    return torch.cat([mesh.xy[t].reshape(-1, 6), mesh.uv[t].reshape(-1, 6),
                      mesh.rgba[t].reshape(-1, 12)], dim=1).to(_F32)


def clip_bounds(clip):
    """A clip rect's bounds as the float32 values the reference compares
    (its Python scalars are weakly typed to the plane's float32)."""
    return tuple(float(np.float32(v)) for v in clip)


def pixel_grid(h: int, w: int, device):
    """(px, py): (H, W) float32 pixel centres."""
    xs = torch.arange(w, dtype=_F32, device=device) + 0.5
    ys = torch.arange(h, dtype=_F32, device=device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px, py


def _bilinear_small(tex, u, v):
    """Bilinear fetch from a small (TH, TW, 4) texture at (H, W) uv."""
    th, tw = tex.shape[:2]
    px = torch.clamp(u * tw - 0.5, 0.0, tw - 1.0)
    py = torch.clamp(v * th - 0.5, 0.0, th - 1.0)
    bx = torch.floor(px).to(torch.int32)
    by = torch.floor(py).to(torch.int32)
    fx = (px - bx)[..., None]
    fy = (py - by)[..., None]
    bx1 = torch.clamp(bx + 1, max=tw - 1).long()
    by1 = torch.clamp(by + 1, max=th - 1).long()
    bx, by = bx.long(), by.long()
    t00 = tex[by, bx]
    t10 = tex[by, bx1]
    t01 = tex[by1, bx]
    t11 = tex[by1, bx1]
    return (t00 * (1 - fx) + t10 * fx) * (1 - fy) + (
        t01 * (1 - fx) + t11 * fx
    ) * fy


def _combine(w0, w1, w2, a0, a1, a2):
    """fma(w2, a2, fma(w0, a0, w1 * a1)) over (H, W, k) planes."""
    w0, w1, w2 = w0[..., None], w1[..., None], w2[..., None]
    return fma(w2, a2, fma(w0, a0, w1 * a1))


def rasterize_mesh(h: int, w: int, mesh: Mesh2D):
    """Resolve one mesh to (rgb (H, W, 3), alpha (H, W)) planes on the
    mesh's device: the triangles in order, the last covering one winning,
    then one texture fetch and the clip rect."""
    dev = mesh.xy.device
    px, py = pixel_grid(h, w, dev)
    eps = torch.tensor(_EPS, device=dev)
    rgba = torch.zeros((h, w, 4), dtype=_F32, device=dev)
    uv = torch.zeros((h, w, 2), dtype=_F32, device=dev)
    covered = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for td in tri_data(mesh):
        x0, y0, x1, y1, x2, y2 = (td[i] for i in range(6))
        area = fma(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)))
        s = torch.where(area < 0.0, -1.0, 1.0).to(_F32)
        inv = s / torch.maximum(area.abs(), eps)
        e0 = fma(x2 - x1, py - y1, -((y2 - y1) * (px - x1))) * s
        e1 = fma(x0 - x2, py - y2, -((y0 - y2) * (px - x2))) * s
        e2 = fma(x1 - x0, py - y0, -((y1 - y0) * (px - x0))) * s
        inside = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (area.abs() > eps)
        w0 = e0 * inv * s
        w1 = e1 * inv * s
        w2 = e2 * inv * s
        new_uv = _combine(w0, w1, w2, td[6:8], td[8:10], td[10:12])
        new_cl = _combine(w0, w1, w2, td[12:16], td[16:20], td[20:24])
        m = inside[..., None]
        rgba = torch.where(m, new_cl, rgba)
        uv = torch.where(m, new_uv, uv)
        covered = covered | inside

    if mesh.tex is not None:
        t = _bilinear_small(mesh.tex, uv[..., 0], uv[..., 1])
        rgba = rgba * t                                # egui: vertex * tex
    alpha = torch.where(covered, rgba[..., 3], 0.0)
    if mesh.clip is not None:
        x0, y0, x1, y1 = clip_bounds(mesh.clip)
        in_clip = (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
        alpha = torch.where(in_clip, alpha, 0.0)
    return rgba[..., :3], alpha


def paint_meshes_plain(img, meshes):
    """R1's plain twin: blend meshes onto (H, W, 3) in submission order,
    on the image's device."""
    h, w = img.shape[:2]
    for mesh in meshes:
        rgb, a = rasterize_mesh(h, w, mesh_to(mesh, img.device))
        img = img * (1.0 - a[..., None]) + rgb * a[..., None]
    return img


def paint_meshes(img, meshes):
    """Blend meshes onto (H, W, 3) in submission order (paint_frame): R1
    on a CUDA image, the plain twin on a CPU one."""
    from sunray_tpu_torch.ops import cuda_overlay

    return cuda_overlay.paint_meshes(img, list(meshes))


# ---------------------------------------------------------------------------
# Tessellators (the egui::epaint tessellation analog, host-side numpy)
# ---------------------------------------------------------------------------


def _mesh_from_lists(xy, uv, rgba, tris, tex=None, clip=None) -> Mesh2D:
    return Mesh2D(
        xy=torch.from_numpy(np.asarray(xy, np.float32).reshape(-1, 2)),
        uv=torch.from_numpy(np.asarray(uv, np.float32).reshape(-1, 2)),
        rgba=torch.from_numpy(np.asarray(rgba, np.float32).reshape(-1, 4)),
        tris=torch.from_numpy(np.asarray(tris, np.int32).reshape(-1, 3)),
        tex=tex,
        clip=clip,
    )


def tess_rect(x0, y0, x1, y1, rgba, rounding: float = 0.0,
              segments: int = 4, clip=None) -> Mesh2D:
    """Axis-aligned rect, optionally with rounded corners (egui-style
    corner fans, `segments` tris per corner)."""
    rgba = tuple(rgba)
    if rounding <= 0.0:
        xy = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        tris = [(0, 1, 2), (0, 2, 3)]
        return _mesh_from_lists(xy, [(0, 0)] * 4, [rgba] * 4, tris,
                                clip=clip)
    r = min(rounding, (x1 - x0) / 2.0, (y1 - y0) / 2.0)
    centers = [
        (x1 - r, y0 + r, -np.pi / 2.0),   # top-right
        (x1 - r, y1 - r, 0.0),            # bottom-right
        (x0 + r, y1 - r, np.pi / 2.0),    # bottom-left
        (x0 + r, y0 + r, np.pi),          # top-left
    ]
    pts = []
    for cx, cy, a0 in centers:
        for k in range(segments + 1):
            a = a0 + (np.pi / 2.0) * k / segments
            pts.append((cx + r * np.cos(a), cy + r * np.sin(a)))
    n = len(pts)
    cx0 = (x0 + x1) / 2.0
    cy0 = (y0 + y1) / 2.0
    xy = [(cx0, cy0)] + pts
    tris = [(0, 1 + i, 1 + (i + 1) % n) for i in range(n)]
    return _mesh_from_lists(xy, [(0, 0)] * (n + 1), [rgba] * (n + 1),
                            tris, clip=clip)


def tess_polyline(points, width, rgba, clip=None) -> Mesh2D:
    """Stroke a polyline as per-segment quads (miterless butt joins)."""
    pts = np.asarray(points, np.float32)
    rgba = tuple(rgba)
    xy = []
    tris = []
    hw = width / 2.0
    for i in range(len(pts) - 1):
        p0, p1 = pts[i], pts[i + 1]
        d = p1 - p0
        ln = float(np.linalg.norm(d))
        if ln < 1e-6:
            continue
        nx, ny = -d[1] / ln * hw, d[0] / ln * hw
        b = len(xy)
        xy += [
            (p0[0] + nx, p0[1] + ny), (p1[0] + nx, p1[1] + ny),
            (p1[0] - nx, p1[1] - ny), (p0[0] - nx, p0[1] - ny),
        ]
        tris += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    if not xy:
        xy = [(0.0, 0.0)] * 3
        tris = [(0, 1, 2)]
        rgba_l = [(0.0,) * 4] * 3
        return _mesh_from_lists(xy, [(0, 0)] * 3, rgba_l, tris, clip=clip)
    return _mesh_from_lists(xy, [(0, 0)] * len(xy), [rgba] * len(xy),
                            tris, clip=clip)


def tess_line(p0, p1, width, rgba, clip=None) -> Mesh2D:
    return tess_polyline([p0, p1], width, rgba, clip=clip)


@functools.lru_cache(maxsize=1)
def font_atlas():
    """(GLYPH_H, GLYPH_W * nglyphs, 4) white-on-transparent atlas from the
    5x7 bitmap font + {char: column index} map (the egui font-texture
    analog, apply_texture_deltas:333-365). Numpy, cached."""
    chars = sorted(_GLYPHS)
    strip = np.zeros((GLYPH_H, GLYPH_W * len(chars), 4), np.float32)
    for i, ch in enumerate(chars):
        g = np.asarray(
            [[c == "1" for c in row] for row in _GLYPHS[ch]], np.float32
        )
        strip[:, i * GLYPH_W : (i + 1) * GLYPH_W, :] = g[..., None]
    return strip, {ch: i for i, ch in enumerate(chars)}


def tess_text(text: str, x, y, rgba, scale: float = 1.0,
              clip=None) -> Mesh2D:
    """One textured quad per glyph into the font atlas."""
    strip, index = font_atlas()
    nchars = strip.shape[1] // GLYPH_W
    rgba = tuple(rgba)
    xy = []
    uv = []
    tris = []
    gw = GLYPH_W * scale
    gh = GLYPH_H * scale
    adv = (GLYPH_W + 1) * scale
    cx = float(x)
    for ch in text:
        ci = index.get(ch.upper())
        if ci is None:
            ci = index[" "]
        u0 = ci / nchars
        u1 = (ci + 1) / nchars
        b = len(xy)
        xy += [(cx, y), (cx + gw, y), (cx + gw, y + gh), (cx, y + gh)]
        uv += [(u0, 0.0), (u1, 0.0), (u1, 1.0), (u0, 1.0)]
        tris += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
        cx += adv
    if not xy:
        xy = [(0.0, 0.0)] * 3
        uv = [(0.0, 0.0)] * 3
        tris = [(0, 1, 2)]
        return _mesh_from_lists(xy, uv, [(0.0,) * 4] * 3, tris,
                                tex=torch.from_numpy(strip), clip=clip)
    return _mesh_from_lists(xy, uv, [rgba] * len(xy), tris,
                            tex=torch.from_numpy(strip), clip=clip)


def plot_lines(values, x0, y0, x1, y1, rgba=(0.3, 0.9, 0.4, 1.0),
               bg=(0.0, 0.0, 0.0, 0.55), width: float = 1.5,
               vmin=None, vmax=None):
    """Frame-time-graph widget: background panel + polyline of `values`
    scaled into the rect. Returns a list of meshes for paint_meshes."""
    v = np.asarray(values, np.float64)
    lo = float(np.min(v)) if vmin is None else vmin
    hi = float(np.max(v)) if vmax is None else vmax
    hi = max(hi, lo + 1e-9)
    xs = np.linspace(x0 + 2, x1 - 2, num=len(v))
    ys = y1 - 2 - (v - lo) / (hi - lo) * (y1 - y0 - 4)
    meshes = [tess_rect(x0, y0, x1, y1, bg, rounding=3.0)]
    if len(v) >= 2:
        meshes.append(tess_polyline(np.stack([xs, ys], axis=1), width,
                                    rgba))
    return meshes


def hud_meshes(lines, frame_ms=None, origin=(6.0, 6.0), scale: float = 1.0):
    """The meshes hud_overlay paints: a rounded panel, one text mesh a
    line and an optional frame-time plot."""
    x, y = origin
    gh = (GLYPH_H + 2) * scale
    tw = max((len(t) for t in lines), default=0) * (GLYPH_W + 1) * scale
    ph = gh * len(lines) + 8
    pw = max(tw + 12, 120.0 if frame_ms is not None else 0.0)
    meshes = [
        tess_rect(x - 4, y - 4, x + pw, y + ph
                  + (34.0 if frame_ms is not None else 0.0),
                  (0.0, 0.0, 0.0, 0.55), rounding=4.0)
    ]
    for i, text in enumerate(lines):
        meshes.append(
            tess_text(text, x, y + i * gh, (1.0, 1.0, 1.0, 1.0),
                      scale=scale)
        )
    if frame_ms is not None and len(frame_ms) >= 2:
        gy0 = y + ph
        meshes += plot_lines(frame_ms, x, gy0, x + pw - 8, gy0 + 28.0)
    return meshes


def hud_overlay(img, lines, frame_ms=None, origin=(6.0, 6.0),
                scale: float = 1.0):
    """Stats HUD built on the painter: rounded panel + text lines +
    optional frame-time plot (the window example's FPS title + egui
    overlay rolled into one)."""
    return paint_meshes(img, hud_meshes(lines, frame_ms, origin, scale))


# ---------------------------------------------------------------------------
# Host-side (numpy) HUD compositor: the interactive loops already hold the
# frame on the host for encoding, so widgets composite there, bbox-limited.
# ---------------------------------------------------------------------------


def _np_blend_rect(img, x0, y0, x1, y1, rgba):
    h, w = img.shape[:2]
    x0i, y0i = max(int(x0), 0), max(int(y0), 0)
    x1i, y1i = min(int(round(x1)), w), min(int(round(y1)), h)
    if x1i <= x0i or y1i <= y0i:
        return
    r, g, b, a = rgba
    img[y0i:y1i, x0i:x1i] *= 1.0 - a
    img[y0i:y1i, x0i:x1i] += np.asarray([r, g, b], np.float32) * a


def _np_text(img, text, x, y, rgba, scale=1):
    h, w = img.shape[:2]
    col = np.asarray(rgba[:3], np.float32)
    a = rgba[3]
    cx = int(x)
    for ch in text:
        m = _glyph_mask(ch)
        if scale > 1:
            m = np.kron(m, np.ones((scale, scale), np.float32))
        gh, gw = m.shape
        if cx + gw >= w or int(y) + gh >= h:
            break
        reg = img[int(y) : int(y) + gh, cx : cx + gw]
        mm = (m * a)[..., None]
        reg *= 1.0 - mm
        reg += col * mm
        cx += gw + scale


def _np_polyline(img, xs, ys, rgba, width=1):
    """Column-sampled polyline (plots are functions of x — draw a short
    vertical segment per column between adjacent samples)."""
    h, w = img.shape[:2]
    col = np.asarray(rgba[:3], np.float32)
    a = rgba[3]
    for i in range(len(xs) - 1):
        x0, x1 = int(xs[i]), int(xs[i + 1])
        for x in range(max(x0, 0), min(x1 + 1, w)):
            t = 0.0 if x1 == x0 else (x - x0) / (x1 - x0)
            yy = ys[i] + t * (ys[i + 1] - ys[i])
            y0i = max(int(yy) - width // 2, 0)
            y1i = min(y0i + width, h)
            img[y0i:y1i, x] = img[y0i:y1i, x] * (1 - a) + col * a


def hud_overlay_np(img, lines, frame_ms=None, origin=(6, 6), scale=1):
    """Numpy twin of hud_overlay operating IN PLACE on a host (H, W, 3)
    float array. Returns img."""
    x, y = origin
    gh = (GLYPH_H + 2) * scale
    tw = max((len(t) for t in lines), default=0) * (GLYPH_W + 1) * scale
    ph = gh * len(lines) + 8
    pw = max(tw + 12, 120 if frame_ms is not None else 0)
    extra = 34 if frame_ms is not None else 0
    _np_blend_rect(img, x - 4, y - 4, x + pw, y + ph + extra,
                   (0.0, 0.0, 0.0, 0.55))
    for i, text in enumerate(lines):
        _np_text(img, text, x, y + i * gh, (1.0, 1.0, 1.0, 1.0),
                 scale=scale)
    if frame_ms is not None and len(frame_ms) >= 2:
        v = np.asarray(frame_ms, np.float64)
        lo, hi = float(v.min()), float(v.max())
        hi = max(hi, lo + 1e-9)
        gy0 = y + ph
        xs = np.linspace(x + 2, x + pw - 10, num=len(v))
        ys = gy0 + 26 - (v - lo) / (hi - lo) * 24
        _np_polyline(img, xs, ys, (0.3, 0.9, 0.4, 1.0))
    return img
