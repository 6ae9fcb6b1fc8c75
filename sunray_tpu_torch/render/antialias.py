"""Primary-visibility silhouette gradients: screen-space edge
antialiasing — port of sunray_tpu/render/antialias.py.

Which triangle wins a pixel is a step function of the geometry and the
camera, so a silhouette moving across the image gives no gradient. This
pass adds the boundary term for primary visibility as nvdiffrast's
antialias operator does: for each pair of adjacent pixels across a
silhouette (different winning triangles and a depth gap), find where the
closer triangle's projected edge crosses the segment between the pixel
centres and blend the two colours by the crossed fraction. The blend is
a differentiable function of the projected vertices, so the image's
gradient w.r.t. vertices and camera picks up the silhouette term, and
the forward image gets analytic edge antialiasing.

The winning triangles' vertices come in one row gather through K8
(gather_rows), whose backward is K8's segment-sum kernel. Everything
else is shifts and elementwise math on (H, W) planes. In a row-sharded
frame the vertical pairs read one halo row above and below the band.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sunray_tpu_torch.ops.cuda_gather import gather_rows
from sunray_tpu_torch.ops.fp import fma, sum3
from sunray_tpu_torch.parallel.halo import exchange_flat_many

# A pair of adjacent pixels is a silhouette when the winning triangles
# differ and the hit distances differ by this relative gap (interior
# edges of a connected surface have continuous depth).
DEPTH_GAP = 0.02
_EPS = 1e-12


def _project_unit(view_proj, x, y, z):
    """World point -> screen position over the image size, (ux, uy) in
    [0, 1] on screen, and `behind` (bool). (P,) components in and out.
    Times (width, height) it is the pixel position, as
    camera.generate_rays places pixel centres (ix + 0.5, iy + 0.5)."""
    cols = [sum3((view_proj[i, 0], view_proj[i, 1], view_proj[i, 2]),
                 (x, y, z)) + view_proj[i, 3] for i in (0, 1, 3)]
    w = torch.where(cols[2].abs() > _EPS, cols[2], _EPS)
    return cols[0] / w * 0.5 + 0.5, cols[1] / w * 0.5 + 0.5, cols[2] <= 0.0


def _edge_crossing(ax, ay, bx, by, ccx, ccy, horizontal, width, height):
    """Crossing parameter e of the screen edge (A, B), given in unit
    screen coordinates, with the unit segment from the pair centre
    (ccx, ccy) toward +x (horizontal) or +y, measured from the first
    pixel's centre. Returns (e, valid).

    The reference's CPU program scales the second point's coordinate
    inside the denominator's subtraction, fma(pb_u, scale, -pa): at a
    crossing through a pixel centre (e exactly 0 or 1, as the Cornell
    box's diagonal edges give) that rounding decides `valid`."""
    if horizontal:
        pa_u, pb_u, qa_u, qb_u, c0, cq = ay, by, ax, bx, ccy, ccx
        p_scale, q_scale = height, width
    else:
        pa_u, pb_u, qa_u, qb_u, c0, cq = ax, bx, ay, by, ccx, ccy
        p_scale, q_scale = width, height
    pa, pb = pa_u * p_scale, pb_u * p_scale
    qa, qb = qa_u * q_scale, qb_u * q_scale
    # The edge spans the scanline through the pair centres.
    crosses = (pa - c0) * (pb - c0) <= 0.0
    denom = fma(pb_u, p_scale, -pa)
    denom = torch.where(denom.abs() > _EPS, denom, _EPS)
    t = (c0 - pa) / denom
    e = fma(qb - qa, t, qa) - cq
    valid = crosses & (e >= 0.0) & (e <= 1.0)
    return torch.where(valid, e, 0.5), valid


def _shift(a, axis):
    """(second, first) pixels of each adjacent pair along `axis` (1 =
    horizontal neighbours, 0 = vertical)."""
    if axis == 1:
        return a[:, 1:], a[:, :-1]
    return a[1:, :], a[:-1, :]


def _pair_blend(img, delta, sv, tri, t_hit, axis, row0=0, height=None):
    """One pass over adjacent pixel pairs along `axis`; returns delta with
    this pass's colour adjustments added.

    row0, height: the planes are a window of rows whose row 0 is global
    row row0 of a height-row image (a band with its halo rows): pixel
    centres take global rows, and a vertical pair with a row outside the
    image is no pair."""
    rows, w = tri.shape
    h = rows if height is None else height
    tri_q, tri_p = _shift(tri, axis)
    t_q, t_p = _shift(t_hit, axis)
    sil = (tri_p != tri_q) & ((t_p - t_q).abs()
                              > DEPTH_GAP * torch.minimum(t_p.abs(), t_q.abs()))

    # The closer pixel owns the silhouette edge.
    p_closer = t_p <= t_q
    edge = []
    for comp in sv:    # 9 planes: ux, uy, behind of each corner
        cq, cp = _shift(comp, axis)
        edge.append(torch.where(p_closer, cp, cq))
    # The first pixel's centre in pair coordinates.
    dev = img.device
    ph, pw = (rows, w - 1) if axis == 1 else (rows - 1, w)
    ccx = (torch.arange(pw, dtype=torch.float32, device=dev)[None, :]
           + 0.5).expand(ph, pw)
    ccy = (torch.arange(row0, row0 + ph, dtype=torch.float32,
                        device=dev)[:, None] + 0.5).expand(ph, pw)

    best_e = torch.full((ph, pw), 0.5, dtype=torch.float32, device=dev)
    best_valid = torch.zeros((ph, pw), dtype=torch.bool, device=dev)
    any_behind = torch.zeros((ph, pw), dtype=torch.bool, device=dev)
    for k in range(3):
        ax_, ay_, bh_a = edge[3 * k:3 * k + 3]
        k2 = (k + 1) % 3
        bx_, by_, bh_b = edge[3 * k2:3 * k2 + 3]
        e, valid = _edge_crossing(ax_, ay_, bx_, by_, ccx, ccy,
                                  axis == 1, w, h)
        any_behind = any_behind | bh_a | bh_b
        # Prefer the crossing with the strongest blend.
        take = valid & (~best_valid
                        | ((e - 0.5).abs() > (best_e - 0.5).abs()))
        best_e = torch.where(take, e, best_e)
        best_valid = best_valid | valid

    active = sil & best_valid & ~any_behind
    if axis == 0 and (row0 < 0 or row0 + rows > h):
        first = torch.arange(row0, row0 + ph, device=dev)[:, None]
        active = active & (first >= 0) & (first + 1 < h)
    e = torch.where(active, best_e, 0.5)

    # e > 0.5: the near surface leaks into the second pixel (q);
    # e < 0.5: the first pixel (p) loses coverage to q's surface.
    # torch.maximum splits a tie's gradient as jnp.maximum does.
    zero = e.new_zeros(())
    alpha_q = torch.maximum(e - 0.5, zero)[..., None]
    alpha_p = torch.maximum(0.5 - e, zero)[..., None]
    cq, cp = _shift(img, axis)
    dq = alpha_q * (cp - cq)
    dp = alpha_p * (cq - cp)
    # delta.at[q].add(dq), then delta.at[p].add(dp): zero-padded planes.
    if axis == 1:
        delta = delta + F.pad(dq, (0, 0, 1, 0))
        return delta + F.pad(dp, (0, 0, 0, 1))
    delta = delta + F.pad(dq, (0, 0, 0, 0, 1, 0))
    return delta + F.pad(dp, (0, 0, 0, 0, 0, 1))


def primary_edge_aa(scene, cfg, tracer, mats, img, tri=None, t_hit=None,
                    grid=None):
    """Antialias `img` (H, W, 3 linear) along primary silhouettes and make
    it differentiable w.r.t. silhouette motion. Visibility ids are
    detached; the blend factors differentiate through the projected
    vertices.

    tri / t_hit: the raw primary-hit (P,) triangle ids (-1 = miss) and
    distances, normally the RIS pass's first walk round
    (gbuffer.PrimaryHit.first_tri / first_t), so no extra trace runs;
    traced here only when absent.

    grid (parallel/halo.ShardGrid): a row-sharded frame; img, tri and
    t_hit hold the band's rows and are given. One row above and below of
    the three is exchanged (img's differentiably), the pairs are formed
    on that window at global rows and the band's rows of the adjustment
    are kept: a pair across a band edge is formed on both ranks, each
    keeping its own pixel's share, so it counts once."""
    h, w = cfg.height, cfg.width
    if (tri is None) != (t_hit is None):
        raise ValueError("pass tri and t_hit together (or neither)")
    if tri is None:
        if grid is not None:
            raise ValueError("a row-sharded frame passes its band's tri and "
                             "t_hit")
        from sunray_tpu_torch.camera import generate_rays
        from sunray_tpu_torch.render.trace import trace_closest

        orig, dirs = generate_rays(mats, w, h)
        hit = trace_closest(tracer, orig.reshape(-1, 3), dirs.reshape(-1, 3))
        tri = torch.where(hit.hit, hit.tri, -1)
        t_hit = torch.where(hit.hit, hit.t, 1e9)

    rows, row0, win = h, 0, img
    if grid is not None:
        rows, row0 = grid.hl + 2, grid.row0 - 1
        win, tri, t_hit = exchange_flat_many(
            [img.reshape(-1, 3), tri.to(torch.int32), t_hit.detach()], 1,
            grid)
        win = win.reshape(rows, w, 3)

    # The winning triangles' world vertices: one K8 row gather, then the
    # projection of each corner (differentiable in vertices and camera).
    v0, v1, v2 = scene.world_triangle_vertices()
    vcat = torch.cat([v0, v1, v2], dim=1).contiguous()       # (T, 9)
    vrows = gather_rows(vcat, tri.to(torch.int32)[None])[0]  # (9, P)
    vp = mats["view_proj"]
    sv = []
    for k in range(3):
        ux, uy, behind = _project_unit(vp, vrows[3 * k], vrows[3 * k + 1],
                                       vrows[3 * k + 2])
        sv += [ux.reshape(rows, w), uy.reshape(rows, w),
               behind.reshape(rows, w)]

    tri_im = tri.reshape(rows, w)
    t_im = t_hit.reshape(rows, w)
    delta = torch.zeros_like(win)
    delta = _pair_blend(win, delta, sv, tri_im, t_im, 1, row0, h)
    delta = _pair_blend(win, delta, sv, tri_im, t_im, 0, row0, h)
    return img + (delta if grid is None else delta[1:-1])
