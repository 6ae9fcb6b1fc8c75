"""R1's binned design, modelled in plain PyTorch on the CPU.

csrc/overlay.cu gives each block a TILE pixel tile. For each mesh in
submission order, a tile that the mesh's union box misses adds the mesh's
uncovered words; otherwise the block culls the mesh's triangle boxes
against the tile CHUNK at a time, last chunk first, keeps the hits in
triangle order, and each pixel not yet covered walks them back to front
to the first triangle that covers it; the chunk loop ends when every
pixel of the tile is covered; a tile that no mesh reaches adds the fold
of every mesh's uncovered words at once. `binned_paint` does the same, tile by
tile, with the kernel's arithmetic and the wrapper's own boxes, thin
triangles and uncovered words (ops/cuda_overlay.pack_meshes). It must
equal the plain twin, render/overlay2d.paint_meshes_plain, bit for bit
(int32 words) on the stress set, a crop of the scale-2 HUD and every
adversarial set of tests/torch_overlay_cases.py; and every pixel that the
plain twin's inside test covers must lie in its triangle's box. The
kernel itself is held to the plain twin on the card in
tests/test_torch_overlay_cuda.py. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from sunray_tpu_torch.ops import cuda_overlay
from sunray_tpu_torch.ops.cuda_overlay import CHUNK, TILE
from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.render import overlay2d
from torch_overlay_cases import (ADVERSARIAL, HUD_LINES, adversarial_set,
                                 frame_times, seeded_image, stress_meshes)

_EPS = np.float32(1e-8)
ADV_SIZE = (45, 70)          # ragged tiles on both axes


def to_mesh(m):
    return overlay2d.Mesh2D(
        xy=torch.from_numpy(m["xy"]), uv=torch.from_numpy(m["uv"]),
        rgba=torch.from_numpy(m["rgba"]), tris=torch.from_numpy(m["tris"]),
        tex=None if m["tex"] is None else torch.from_numpy(m["tex"]),
        clip=m["clip"])


def meets(box, x0, y0, x1, y1):
    return (box[..., 0] <= x1) & (box[..., 2] >= x0) & \
        (box[..., 1] <= y1) & (box[..., 3] >= y0)


def edges(td, px, py):
    """(3, K, P) edge functions times s of the K records `td` at the P
    pixels, as the plain twin computes them; (K,) s; (K,) area."""
    x0, y0, x1, y1, x2, y2 = (td[:, i, None] for i in range(6))
    area = fma(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)))
    s = torch.where(area < 0.0, -1.0, 1.0).to(torch.float32)
    px, py = px[None], py[None]
    e0 = fma(x2 - x1, py - y1, -((y2 - y1) * (px - x1))) * s
    e1 = fma(x0 - x2, py - y2, -((y0 - y2) * (px - x2))) * s
    e2 = fma(x1 - x0, py - y0, -((y1 - y0) * (px - x0))) * s
    return torch.stack([e0, e1, e2]), s[:, 0], area[:, 0]


def passes(td, px, py):
    """(K, P): the walk's inside test of the K staged hits `td` at the P
    pixels, as the kernel computes it: each edge with s folded into its
    differences, fma(s dx, py - y_j, -((s dy) * (px - x_j))) >= 0."""
    x0, y0, x1, y1, x2, y2 = (td[:, i, None] for i in range(6))
    area = fma(x1 - x0, y2 - y0, -((x2 - x0) * (y1 - y0)))
    s = torch.where(area < 0.0, -1.0, 1.0).to(torch.float32)
    px, py = px[None], py[None]
    out = torch.ones((td.shape[0], px.shape[1]), dtype=torch.bool)
    for (xa, ya), (xb, yb) in (((x1, y1), (x2, y2)), ((x2, y2), (x0, y0)),
                               ((x0, y0), (x1, y1))):
        out &= fma(s * (xb - xa), py - ya, -((s * (yb - ya)) * (px - xa))) >= 0.0
    return out


def walk_mesh(p, m, tile, px, py, stats):
    """One block's walk of mesh m over its live pixels: (covered (P,),
    the winners' uv (P, 2) and colour (P, 4))."""
    x0, y0 = tile
    x1, y1 = x0 + TILE[0] - 1, y0 + TILE[1] - 1
    start, count = (int(v) for v in p.meta[m, :2])
    n_px = px.shape[0]
    covered = torch.zeros(n_px, dtype=torch.bool)
    uv = torch.zeros((n_px, 2))
    rgba = torch.zeros((n_px, 4))
    for t0 in range((count - 1) // CHUNK * CHUNK, -1, -CHUNK):
        ids = start + t0 + torch.arange(min(CHUNK, count - t0))
        ids = ids[meets(p.boxes[ids], x0, y0, x1, y1)]
        td = p.tris[ids]
        _, _, area = edges(td, px[:0], py[:0])
        keep = area.abs() > _EPS
        ids = ids[keep]                           # the staged hits, in order
        inside = passes(td[keep], px, py) & ~covered     # (K, P)
        stats["tests"] += int((~covered).sum()) * ids.shape[0]
        found = inside.any(0)
        if found.any():
            # Back to front, the first that covers: the last in order.
            k = ids.shape[0] - 1 - inside.flip(0).int().argmax(0)[found]
            td = p.tris[ids[k]]
            # The winner's own pixel, in the plain twin's arithmetic.
            e, s, area = edges(td, px[found], py[found])
            pick = torch.arange(td.shape[0])
            ew = e[:, pick, pick]
            inv = s / area.abs()
            w0, w1, w2 = (ew[i] * inv * s for i in range(3))
            combine = lambda lo, n: fma(
                w2[:, None], td[:, lo + 2 * n: lo + 3 * n],
                fma(w0[:, None], td[:, lo: lo + n],
                    w1[:, None] * td[:, lo + n: lo + 2 * n]))
            uv[found] = combine(6, 2)
            rgba[found] = combine(12, 4)
            covered |= found
        if covered.all():
            break
    return covered, uv, rgba


def binned_paint(img, meshes, stats=None):
    """paint_meshes as R1's blocks compute it, tile by tile."""
    stats = {"tests": 0, "skipped": 0, "alone": 0} if stats is None else stats
    h, w = img.shape[:2]
    p = cuda_overlay.pack_meshes(meshes, h, w, "cpu")
    out = torch.empty_like(img)
    for ty in range(0, h, TILE[1]):
        for tx in range(0, w, TILE[0]):
            py, px = torch.meshgrid(
                torch.arange(ty, min(ty + TILE[1], h), dtype=torch.float32)
                + 0.5,
                torch.arange(tx, min(tx + TILE[0], w), dtype=torch.float32)
                + 0.5, indexing="ij")
            shape = px.shape
            px, py = px.reshape(-1), py.reshape(-1)
            c = img[ty: ty + TILE[1], tx: tx + TILE[0]].reshape(-1, 3)
            n_meshes = len(meshes)
            alone = n_meshes and not meets(
                p.ubox[n_meshes], tx, ty, tx + TILE[0] - 1, ty + TILE[1] - 1)
            if alone:
                c = c + p.zero[n_meshes]            # the fold of every mesh's
                stats["alone"] += 1
            for m in range(0 if alone else n_meshes):
                if not meets(p.ubox[m], tx, ty, tx + TILE[0] - 1,
                             ty + TILE[1] - 1):
                    c = c + p.zero[m]
                    stats["skipped"] += 1
                    continue
                covered, uv, rgba = walk_mesh(p, m, (tx, ty), px, py, stats)
                off, th, tw, clipped = (int(v) for v in p.meta[m, 2:])
                if off >= 0:
                    tex = p.pool[off: off + th * tw * 4].reshape(th, tw, 4)
                    rgba = rgba * overlay2d._bilinear_small(tex, uv[:, 0],
                                                            uv[:, 1])
                a = rgba[:, 3]
                if clipped:
                    cx0, cy0, cx1, cy1 = p.clip[m]
                    a = torch.where((px >= cx0) & (px < cx1) & (py >= cy0)
                                    & (py < cy1), a, 0.0)
                blend = c * (1.0 - a[:, None]) + rgba[:, :3] * a[:, None]
                c = torch.where(covered[:, None], blend, c + p.zero[m])
            out[ty: ty + TILE[1], tx: tx + TILE[0]] = c.reshape(*shape, 3)
    return out


def assert_bits(got, want):
    a = got.numpy().view(np.int32)
    b = want.numpy().view(np.int32)
    assert (a != b).sum() == 0, f"{(a != b).sum()} words differ"


def hud_set():
    img = torch.from_numpy(seeded_image(200, 400, 13))
    return img, overlay2d.hud_meshes(HUD_LINES, frame_ms=frame_times(120, 14),
                                     scale=2.0)


def stress_set(h, w, n_tris):
    return (torch.from_numpy(seeded_image(h, w, 12)),
            [to_mesh(m) for m in stress_meshes(h, w, n_tris, 11)])


def named_set(name):
    if name == "hud":
        return hud_set()
    if name.startswith("stress"):
        _, h, w, n = name.split("_")
        return stress_set(int(h), int(w), int(n))
    img, meshes = adversarial_set(name, *ADV_SIZE, seed=21)
    return torch.from_numpy(img), [to_mesh(m) for m in meshes]


SETS = [f"stress_61_97_{3 * CHUNK + 5}", "stress_61_97_2000",
        f"stress_{3 * TILE[1] + 5}_{3 * TILE[0] + 5}_{3 * CHUNK + 5}", "hud",
        *ADVERSARIAL]


@pytest.mark.parametrize("name", SETS)
def test_binned_walk_is_the_plain_twin(name):
    img, meshes = named_set(name)
    stats = {"tests": 0, "skipped": 0, "alone": 0}
    got = binned_paint(img, meshes, stats)
    assert_bits(got, overlay2d.paint_meshes_plain(img, meshes))
    h, w = img.shape[:2]
    # The binned walk tests fewer (pixel, triangle) pairs than every pixel
    # against every triangle.
    n_tris = sum(int(m.tris.shape[0]) for m in meshes)
    assert stats["tests"] < h * w * n_tris


def plain_inside(td, h, w):
    """(K, H, W): the plain twin's inside test of the K records td."""
    px, py = overlay2d.pixel_grid(h, w, "cpu")
    e, _, area = edges(td, px.reshape(-1), py.reshape(-1))
    inside = (e >= 0.0).all(0) & (area.abs() > _EPS)[:, None]
    return inside.reshape(-1, h, w)


@pytest.mark.parametrize("name", SETS)
def test_boxes_hold_every_covered_pixel(name):
    img, meshes = named_set(name)
    h, w = img.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    for mesh in meshes:
        td = overlay2d.tri_data(mesh)
        boxes = torch.from_numpy(cuda_overlay.triangle_boxes(td.numpy(), h, w))
        for k in range(0, td.shape[0], CHUNK):
            inside = plain_inside(td[k: k + CHUNK], h, w)
            b = boxes[k: k + CHUNK, :, None, None]
            held = meets(torch.stack([xs, ys, xs, ys], -1)[None],
                         b[:, 0], b[:, 1], b[:, 2], b[:, 3])
            assert not (inside & ~held).any(), (
                f"{int((inside & ~held).sum())} covered pixels outside "
                "their triangle's box")
