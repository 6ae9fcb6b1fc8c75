"""R1: the 2D overlay painter, every mesh rasterised and blended in one
launch.

Counterpart of sunray_tpu/render/overlay2d.py: rasterize_mesh and
paint_meshes (:79-155), which have no pallas_call: the reference runs
each mesh as a lax.scan over its triangles, about 20 elementwise
operations over the whole (H, W) plane a triangle, then a texture fetch,
a clip and a blend, each over the plane again. The kernel is
csrc/overlay.cu: one block a 16 x 16 pixel tile walks the meshes in
submission order. A mesh whose pixel box misses the tile adds its
uncovered words (`uncovered_words`) and nothing else; otherwise the block
culls the mesh's triangle boxes (`triangle_boxes`) against the tile a
chunk at a time, last chunk first, and each pixel walks the chunk's hits
back to front to the first triangle that covers it. It is bit-equal to
the plain twin, render/overlay2d.paint_meshes_plain, which is the CPU
path.

`pack_meshes` makes the kernel's inputs once a call, on the host (the
CPU tests check this very code): the triangle records, their boxes, each
mesh's metadata, union box, clip rect and uncovered words, the union and
fold of those for all meshes (a tile that no mesh reaches adds the fold
alone), and the texels; two copies take them to the image's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sunray_tpu_torch.ops import cuda_build

# csrc/overlay.cu: one thread a pixel of a TILE[0] x TILE[1] tile; CHUNK
# triangle boxes culled (one a thread) and the hits staged a round.
TILE = (16, 16)
CHUNK = 256

_EPS = float(np.float32(1e-8))     # the inside test's |area| > 1e-8
_U = 2.0 ** -24                    # float32's unit roundoff
# The host's area (`_fma`, as ops/fp.fma) rounds through float64, so it
# may sit one float32 ulp (relative 2^-23) from the kernel's fmaf at a
# rounding midpoint.
_FMA_SLACK = 2.0 ** -22
_TINY = 1e-37                      # what an underflowing rounding can lose
_HUGE = 2.0 ** 48                  # coordinates whose products stay finite


class Packed(NamedTuple):
    """R1's arguments for one call; `tris` and `boxes` hold every
    triangle of every mesh in submission order. Row M of `ubox` and `zero`
    is for all the meshes together: the union of their boxes and the fold
    of their uncovered words (`fold_words`)."""
    tris: torch.Tensor     # (T, 24) float32: positions, uvs, colours
    boxes: torch.Tensor    # (T, 4) int32 pixel box (x0, y0, x1, y1), inclusive
    meta: torch.Tensor     # (M, 6) int32: tri start and count, texel
                           # offset, texture h and w, clip flag
    ubox: torch.Tensor     # (M + 1, 4) int32: the union of the mesh's boxes
    clip: torch.Tensor     # (M, 4) float32 clip rects
    zero: torch.Tensor     # (M + 1, 3) float32: what an uncovered pixel adds
    pool: torch.Tensor     # the textures' texels, float32


def _fma(a, b, c):
    """ops/fp.fma on float32 numpy arrays: the float64 sum of the exact
    product and c, rounded to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def triangle_boxes(td, h, w):
    """(T, 4) int64 pixel boxes (x0, y0, x1, y1), inclusive, of the
    triangles in the (T, 24) float32 records `td` (numpy) on an (h, w)
    image: every pixel whose centre can pass the kernel's inside test lies
    in its triangle's box. A triangle that can cover no pixel of the image
    gets the empty box (w, h, -1, -1).

    The argument (csrc/overlay.cu's note has it in full): the kernel's
    |area| is within one float32 ulp of `_fma`'s here, so |area| <= 1e-8
    (or NaN: a NaN coordinate) is certain below (1 + 2^-22) of it. Each
    fmaf-rounded edge function is within 5u (|P| + |Q|) <= 10 u L D of
    the exact one (u = 2^-24, L the box's longer side, D = max(h, w) plus
    the largest |coordinate|), the area within 10 u L^2. Where |area| is
    larger than that area error, its sign is the exact sign, and a pixel
    whose three rounded edge functions pass lies within L * 3 err / (|area|
    - err_area) of the vertex box. Where it is not, or where a coordinate
    is not finite or beyond 2^48 (its products could overflow), the
    triangle is thin: its box is the whole image."""
    with np.errstate(all="ignore"):
        x0, y0, x1, y1, x2, y2 = td[:, :6].T
        area = _fma(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)))  # the kernel's
        aa = np.abs(area.astype(np.float64))
        empty = ~(aa * (1.0 + _FMA_SLACK) > _EPS)            # NaN: empty too
        xy = td[:, :6].astype(np.float64).reshape(-1, 3, 2)
        lo, hi = xy.min(1), xy.max(1)                        # (T, 2): x, y
        big = np.abs(xy).reshape(-1, 6).max(1)     # NaN or inf: not <= _HUGE
        side = (hi - lo).max(1)
        room = aa * (1.0 - _FMA_SLACK) - (10.0 * _U * side * side + _TINY)
        err_edge = 10.0 * _U * side * (max(h, w) + big) + _TINY
        whole = ~((big <= _HUGE) & (room > 0.0)) | empty     # thin, or empty
        margin = np.where(whole, 0.0, side * 3.0 * err_edge / room)[:, None]
        # Pixel i passes only if i + 0.5 lies within the margin of the
        # vertex box; floor and ceil widen by under a pixel, more than
        # float64 drifts. Bounds are clamped before they become ints.
        first = np.where(whole[:, None], 0.0, np.floor(lo - margin - 0.5))
        last = np.where(whole[:, None], float(max(h, w)),
                        np.ceil(hi + margin - 0.5))
    first = np.clip(first, 0, [w, h]).astype(np.int64)
    last = np.clip(last, -1, [w - 1, h - 1]).astype(np.int64)
    box = np.concatenate([first, last], 1)
    empty |= (first > last).any(1)
    box[empty] = (w, h, -1, -1)
    return box


def union_boxes(boxes, counts, h, w):
    """(M, 4) int64: each mesh's union of its triangles' boxes (counts:
    the meshes' triangle counts, in order); (w, h, -1, -1) for a mesh
    whose triangles cover no pixel."""
    out = np.tile(np.array([w, h, -1, -1], np.int64), (len(counts), 1))
    some = np.asarray(counts) > 0
    if some.any():
        starts = (np.cumsum(counts) - counts)[some]
        out[some, :2] = np.minimum.reduceat(boxes[:, :2], starts, axis=0)
        out[some, 2:] = np.maximum.reduceat(boxes[:, 2:], starts, axis=0)
    return out


def uncovered_words(pool, corners):
    """(M, 3) float32 tensor: what a pixel that no triangle of the mesh
    covers adds to the image. There the kernel and the plain twin compute
    rgb = 0 * texel, from the bilinear fetch at uv (0, 0): weights 1 and 0
    on the texels (0, 0), (0, 1), (1, 0) and (1, 1) clamped, whose first
    words in the (N,) texel pool are `corners` (M, 4) in the order t00,
    t10, t01, t11 (an untextured mesh's point at ones). It is blended with
    alpha 0, img * 1 + rgb * 0, so the words are (0 * texel) * 0: +0, -0,
    or NaN where a texel the fetch reads is not finite; +0 untextured.
    Torch ops, as the plain twin's: where two NaNs meet, torch's add keeps
    the second's bits on the CPU and numpy's the first's."""
    t00, t10, t01, t11 = (pool[corners[:, k, None] + torch.arange(3)]
                          for k in range(4))
    t = (t00 * 1.0 + t10 * 0.0) * 1.0 + (t01 * 1.0 + t11 * 0.0) * 0.0
    return (0.0 * t) * 0.0


def fold_words(zero):
    """(3,) float32: the (M, 3) uncovered words summed in mesh order,
    ((z_0 + z_1) + ...) + z_{M-1}, with torch's adds. Each word is +0, -0
    or NaN, so img + z_0 + ... + z_{M-1} is img + the sum bit for bit: a
    sum of zeros is -0 only where every term is, img + +-0 is img unless
    img is a zero, and the NaNs meet in the same adds, in the same order
    (the card's NaN is canonical in any case)."""
    total = zero[0]
    for row in zero[1:]:
        total = total + row
    return total


def _host(tensors, dtype):
    """The tensors joined on the host as one numpy array: joined where
    they lie, then copied once."""
    if len({t.device for t in tensors}) > 1:
        tensors = [t.cpu() for t in tensors]
    return torch.cat(tensors).detach().cpu().numpy().astype(dtype, copy=False)


def pack_meshes(meshes, h, w, device):
    """R1's inputs (`Packed`) for `meshes` over an (h, w) image, on
    `device`. They are computed on the host with numpy, where
    hud_overlay's tessellators build the meshes: as torch ops on the card,
    ~126 small launches at ~14 us of host time each on an H100 machine,
    they made a call 2-2.5x slower than the first kernel's whole call
    (PERF.md, R1's findings). Two copies take them to `device`, one of
    float32 and one of int32 words, each field a view; the fields the
    kernel reads as vectors (tris, boxes, ubox) start at 16-byte
    multiples."""
    from sunray_tpu_torch.render.overlay2d import clip_bounds

    if not meshes:
        raise cuda_build.KernelError("paint_meshes: no mesh to pack")
    m = len(meshes)
    counts = np.array([int(mesh.tris.shape[0]) for mesh in meshes])
    n_verts = np.array([int(mesh.xy.shape[0]) for mesh in meshes])
    texs = [mesh.tex for mesh in meshes if mesh.tex is not None]
    if any(tex.dim() != 3 or tex.shape[2] != 4 for tex in texs):
        raise cuda_build.KernelError("paint_meshes: textures must be "
                                     "(TH, TW, 4)")
    shape = np.array([tuple(mesh.tex.shape[:2]) if mesh.tex is not None
                      else (0, 0) for mesh in meshes]).reshape(-1, 2)
    size = 4 * shape[:, 0] * shape[:, 1]
    off = np.where(size > 0, np.cumsum(size) - size, -1)
    verts = np.concatenate([_host([getattr(mesh, k) for mesh in meshes],
                                  np.float32) for k in ("xy", "uv", "rgba")],
                           1)
    index = _host([mesh.tris for mesh in meshes], np.int64)
    index = index + np.repeat(np.cumsum(n_verts) - n_verts, counts)[:, None]
    g = verts[index]                                             # (T, 3, 8)
    tris = np.concatenate([g[..., 0:2].reshape(-1, 6),
                           g[..., 2:4].reshape(-1, 6),
                           g[..., 4:8].reshape(-1, 12)], 1)
    pool = (_host([tex.reshape(-1) for tex in texs], np.float32) if texs
            else np.zeros(0, np.float32))
    pool = np.concatenate([pool, np.ones(4, np.float32)])
    # The four texels the fetch at uv (0, 0) reads: rows and columns 0 and
    # min(1, size - 1); an untextured mesh's, the ones at the end.
    c1 = np.minimum(1, shape[:, 1] - 1)
    r1w = np.minimum(1, shape[:, 0] - 1) * shape[:, 1]
    corners = np.where(off[:, None] >= 0, off[:, None] + 4 * np.stack(
        [0 * c1, c1, r1w, r1w + c1], 1), pool.size - 4)
    boxes = triangle_boxes(tris, h, w)
    ubox = union_boxes(boxes, counts, h, w)
    ubox = np.concatenate([ubox, union_boxes(ubox, [m], h, w)])
    zero = uncovered_words(torch.from_numpy(pool), torch.from_numpy(corners))
    zero = torch.cat([zero, fold_words(zero)[None]]).numpy()
    meta = np.stack([np.cumsum(counts) - counts, counts, off, shape[:, 0],
                     shape[:, 1], [mesh.clip is not None for mesh in meshes]],
                    1)
    clip = np.array([clip_bounds(mesh.clip) if mesh.clip is not None
                     else (0.0,) * 4 for mesh in meshes], np.float32)
    floats = [tris, zero, clip, pool]
    ints = [boxes, ubox, meta]
    fields = {}
    for group, dtype in ((floats, np.float32), (ints, np.int32)):
        flat = torch.from_numpy(np.concatenate(
            [a.reshape(-1) for a in group]).astype(dtype)).to(device)
        for a, part in zip(group, flat.split([a.size for a in group])):
            fields[id(a)] = part.view(a.shape)
    return Packed(fields[id(tris)], fields[id(boxes)], fields[id(meta)],
                  fields[id(ubox)], fields[id(clip)], fields[id(zero)],
                  fields[id(pool)])


def paint_meshes(img, meshes):
    """Blend `meshes` (render/overlay2d.Mesh2D) onto the (H, W, 3) float32
    image in submission order; returns a new image. R1 on a CUDA image,
    the plain twin on a CPU one."""
    name = "paint_meshes"
    if img.dim() != 3 or img.shape[2] != 3 or img.dtype != torch.float32:
        raise cuda_build.KernelError(f"{name}: img must be (H, W, 3) float32, "
                                     f"got {img.dtype} {tuple(img.shape)}")
    if cuda_build.on_cpu(img):
        from sunray_tpu_torch.render.overlay2d import paint_meshes_plain

        return paint_meshes_plain(img, meshes)
    img = img.contiguous()
    cuda_build.require_cuda(name, img)
    if not meshes:
        return img.clone()
    h, w = img.shape[:2]
    return _launch_paint(img, pack_meshes(meshes, h, w, img.device))


def _launch_paint(img, packed, lib=None):
    """R1 once on `packed` (pack_meshes), from `lib` (default: the port's
    library, whose launches are counted)."""
    h, w = img.shape[:2]
    p = packed
    if any(t.data_ptr() % 16 for t in (p.tris, p.boxes, p.ubox)):
        raise cuda_build.KernelError("paint_meshes: the triangle records and "
                                     "boxes must be 16-byte aligned")
    out = torch.empty_like(img)
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_paint_meshes(
        img.data_ptr(), out.data_ptr(), h, w, p.tris.data_ptr(),
        p.boxes.data_ptr(), p.meta.data_ptr(), p.ubox.data_ptr(),
        p.clip.data_ptr(), p.zero.data_ptr(), p.pool.data_ptr(),
        p.meta.shape[0], cuda_build.stream_ptr())
    cuda_build.check_launch("paint_meshes", err)
    if lib is None:
        cuda_build.launches["paint_meshes"] += 1
    return out
