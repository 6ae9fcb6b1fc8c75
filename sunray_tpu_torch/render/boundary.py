"""Shadow-boundary (visibility) gradients for first-bounce NEE — port of
sunray_tpu/render/boundary.py.

NEE's visibility V(x, y) is a step function of the scene, so a shadow
edge sweeping across a receiver gives no reverse-mode gradient. This
module adds the boundary term of

    I(x) = sum_lights integral_light f(x, y) V(x, y) dA(y)

by deterministic silhouette-edge quadrature (Li et al. 2018, the
secondary-discontinuity boundary integral, with fixed quadrature):

  d I/d theta += sum_{silhouette edges e} int_{y on proj_x(e) ∩ light}
                   f(x, y) <dy/dtheta, n_dark(y)> dl(y)

as a zero-forward expression: the caller adds `term`, which is
out - out.detach(), exactly zero in the forward pass. Only y(theta) (the
quadrature points projected from x through the edge onto the light's
plane) keeps its graph; every coefficient (f, dl, the masks) is
computed from detached tensors under torch.no_grad(), as the reference
stop_gradients them. n_dark keeps the reference's dependence on the
light's normal (its curve tangent reads the live normal), which carries
a gradient only where the light geometry requires one.

Two paths, as in the reference: dense quadrature over every (pixel,
edge) pair (candidates=0), or, for each light, the top-K silhouette
candidates of each pixel (B1, ops/cuda_boundary.py, a hand kernel on the
card) with their endpoints fetched through K8 (gather_rows, whose
backward is K8's segment-sum kernel).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sunray_tpu_torch.ops import cuda_boundary
from sunray_tpu_torch.ops.cuda_gather import gather_rows
from sunray_tpu_torch.ops.fp import cross, dot, fma, sqrt


def build_edge_topology(scene):
    """Host-side unique-edge extraction from the scene's arrays (numpy).

    Edges are deduplicated by quantized world-space endpoint positions
    per instance (flat-shaded meshes duplicate vertices per face).
    Returns (edge_tri (E, 2) int32, edge_k (E,) int32) on the scene's
    device: edge e is local edge k of world triangle edge_tri[e, 0]
    (corners k, (k + 1) % 3), and edge_tri[e, 1] is the other face
    sharing it (-1 = open boundary)."""
    tri_vidx = scene.tri_vidx.cpu().numpy()
    tri_inst = scene.tri_inst.cpu().numpy()
    pos = scene.positions.detach().cpu().numpy()
    xf = scene.inst_transform.detach().cpu().numpy()    # (I, 3, 4)

    world = (
        np.einsum("tij,tkj->tki", xf[tri_inst][:, :, :3], pos[tri_vidx])
        + xf[tri_inst][:, None, :, 3]
    )                                                   # (T, 3, 3)
    q = np.round(world / 1e-5).astype(np.int64)         # quantized corners

    seen: dict = {}
    edge_tri = []
    edge_k = []
    for t in range(q.shape[0]):
        for k in range(3):
            a = tuple(q[t, k]) + (int(tri_inst[t]),)
            b = tuple(q[t, (k + 1) % 3]) + (int(tri_inst[t]),)
            key = (a, b) if a <= b else (b, a)
            if key in seen:
                e = seen[key]
                if edge_tri[e][1] == -1:
                    edge_tri[e] = (edge_tri[e][0], t)
                # More than two faces on one edge: keep the first two.
            else:
                seen[key] = len(edge_tri)
                edge_tri.append((t, -1))
                edge_k.append(k)
    dev = scene.positions.device
    return (
        torch.from_numpy(np.asarray(edge_tri, np.int32).reshape(-1, 2)).to(dev),
        torch.from_numpy(np.asarray(edge_k, np.int32)).to(dev),
    )


def with_edge_topology(scene):
    """The scene with edge_tri / edge_k filled (host-side, at scene
    build time)."""
    et, ek = build_edge_topology(scene)
    return dataclasses.replace(scene, edge_tri=et, edge_k=ek)


def _tri_corner(w0, w1, w2, tri, k):
    """World corner k of triangles `tri`: (N,) indices -> (N, 3)."""
    tri = tri.long()
    return torch.where((k == 0)[:, None], w0[tri],
                       torch.where((k == 1)[:, None], w1[tri], w2[tri]))


def _edge_geometry(tris_w, e_t, e_k):
    """Differentiable endpoints a, b (E, 3), and the detached data the
    classification reads: (a, b, edge_table, c_opp1, c_opp2)."""
    w0, w1, w2 = tris_w
    t1 = e_t[:, 0]
    a = _tri_corner(w0, w1, w2, t1, e_k)
    b = _tri_corner(w0, w1, w2, t1, (e_k + 1) % 3)
    with torch.no_grad():
        v = tuple(w.detach() for w in tris_w)

        def face(tri):
            tric = torch.clamp(tri, min=0).long()
            v0, v1, v2 = (x[tric] for x in v)
            n = cross(v1 - v0, v2 - v0)
            n = n / torch.clamp(sqrt(dot(n, n)), min=1e-12)[:, None]
            return n, v0, (v0 + v1) + v2

        n1, c1, s1 = face(t1)
        n2, c2, s2 = face(e_t[:, 1])
        ad, bd = a.detach(), b.detach()
        table = cuda_boundary.edge_table(ad, bd, n1, c1, n2, c2,
                                         e_t[:, 1] >= 0)
        # The opposite corner by position arithmetic (v0 + v1 + v2 - a - b).
        c_opp1 = s1 - ad - bd
        c_opp2 = s2 - ad - bd
    return a, b, table, c_opp1, c_opp2


def nee_boundary_term(scene, lights, tris_w, x, normal, albedo, nee_mask,
                      quadrature: int = 4, candidates: int = 0):
    """The zero-forward boundary-gradient injection for first-bounce NEE.

    scene: SceneBuffers with edge topology (with_edge_topology).
    lights: restir.Lights. tris_w: (w0, w1, w2) differentiable world
    triangle corners (scene.world_triangle_vertices(), not the tracer's
    detached copy). x: (P, 3) shading points (differentiable);
    normal / albedo: the NEE lanes' shading attributes; nee_mask: (P,)
    lanes running the NEE estimator.

    Returns (P, 3): exactly zero in the forward pass; its gradient is the
    visibility boundary term of the diffuse NEE integrand
    f = em * albedo / pi * cos_s * cos_l / d^2."""
    e_t, e_k = scene.edge_tri, scene.edge_k
    e_n = e_t.shape[0]
    p = x.shape[0]
    a, b, table, c_opp1, c_opp2 = _edge_geometry(tris_w, e_t, e_k)
    xs = x.detach()
    out = torch.zeros((p, 3), dtype=torch.float32, device=x.device)
    pruned = bool(candidates) and candidates < e_n
    with torch.no_grad():
        if pruned:
            lt = cuda_boundary.light_table(lights.v0.detach(),
                                           lights.v1.detach(),
                                           lights.v2.detach())
            idx, n_live, sil, face2 = cuda_boundary.boundary_candidates(
                xs.contiguous(), nee_mask.contiguous(), table, lt, candidates)
        else:
            # Dense: every edge at every pixel (boundary.py:234-245).
            sil, face2 = cuda_boundary.silhouette(xs, table)
            valid_pe = nee_mask[:, None] & sil
            c_opp_pe = torch.where(face2[..., None], c_opp2, c_opp1)
    if pruned:
        ab_table = torch.cat([a, b], dim=1).contiguous()       # (E, 6)
        ranks = torch.arange(candidates, device=x.device)
    for li in range(lights.num):
        light = (lights.v0[li], lights.v1[li], lights.v2[li],
                 lights.emission[li])
        if pruned:
            # The K ranks of this light together: (P, K) edge sets, their
            # endpoints gathered through K8 (differentiable).
            k_idx = idx[li]                                     # (K, P)
            ends = gather_rows(ab_table, k_idx).permute(2, 0, 1)  # (P, K, 6)
            with torch.no_grad():
                valid_pe = (nee_mask[:, None]
                            & (n_live[li][:, None] > ranks[None, :])
                            & sil[li].T)
                kl = k_idx.T.long()
                c_opp_pe = torch.where(face2[li].T[..., None], c_opp2[kl],
                                       c_opp1[kl])
            out = out + _edge_light_quadrature(
                x, xs, normal, albedo, valid_pe, ends[..., :3], ends[..., 3:],
                c_opp_pe, light, quadrature)
        else:
            out = out + _edge_light_quadrature(
                x, xs, normal, albedo, valid_pe, a[None].expand(p, -1, -1),
                b[None].expand(p, -1, -1), c_opp_pe, light, quadrature)
    return out - out.detach()


def _edge_light_quadrature(x, xs, normal, albedo, valid_pe, a_pe, b_pe,
                           c_opp_pe, light, quadrature):
    """The boundary-integral quadrature (boundary.py:300-396) for
    per-pixel edge sets: a_pe / b_pe (P, E', 3) differentiable endpoints,
    c_opp_pe (P, E', 3) detached side reference, valid_pe (P, E')
    classification. Returns (P, 3)."""
    p0, p1, p2, em = light
    nl = cross(p1 - p0, p2 - p0)
    nl_u = nl / torch.clamp(sqrt(dot(nl, nl)), min=1e-12)
    s_q = (torch.arange(quadrature, dtype=torch.float32, device=x.device)
           + 0.5) / quadrature

    a, b = a_pe, b_pe
    # Quadrature points on every edge, (P, E', S, 3), differentiable.
    e_pt = fma(s_q[None, None, :, None], (b - a)[:, :, None, :],
               a[:, :, None, :])
    d = e_pt - x[:, None, None, :]
    denom = dot(d, nl_u)
    cnum = dot(p0 - x, nl_u)[:, None, None]
    t_hit = cnum / torch.where(denom.abs() > 1e-9, denom, 1e-9)
    y = fma(t_hit[..., None], d, x[:, None, None, :])          # (P, E', S, 3)

    with torch.no_grad():
        ys, td, sd, sc = y.detach(), t_hit.detach(), d.detach(), cnum.detach()
        sden, nlu = denom.detach(), nl_u.detach()
        behind = td <= cuda_boundary.BEYOND    # edge not between x and plane
        q = (p0.detach(), p1.detach(), p2.detach())

        def edge_fn(q0, q1):
            return dot(cross(q1 - q0, ys - q0), nlu)

        s0, s1, s2 = edge_fn(q[0], q[1]), edge_fn(q[1], q[2]), edge_fn(q[2], q[0])
        inside = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
                  | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
        ab = (b - a).detach()[:, :, None, :]
        den2 = torch.where(sden.abs() > 1e-9, sden * sden, 1e-9)[..., None]
        # Edge plane (through x, containing the edge) and the dark side.
        ad = a.detach()
        np_ = cross(ab[:, :, 0, :], xs[:, None, :] - ad)        # (P, E', 3)
        face_side = dot(c_opp_pe - ad, np_)                     # (P, E')

    # The curve tangent dy/ds and its in-plane normal read the live
    # light normal, as in the reference (boundary.py:342-352).
    dts = -sc[..., None] * dot(ab, nl_u)[..., None] / den2
    dy_ds = fma(dts, sd, td[..., None] * ab)
    n0 = cross(nl_u, dy_ds)
    n0 = n0 / torch.clamp(sqrt(dot(n0, n0)), min=1e-12)[..., None]

    with torch.no_grad():
        y_side = dot(n0.detach(), np_[:, :, None, :])           # (P, E', S)
        orient = torch.sign(face_side[:, :, None] * y_side)
        # Diffuse NEE integrand density at y.
        v = ys - xs[:, None, None, :]
        dist = torch.clamp(sqrt(dot(v, v)), min=1e-4)
        ldir = v / dist[..., None]
        cos_s = torch.clamp(dot(normal.detach()[:, None, None, :], ldir),
                            min=0.0)
        cos_l = torch.clamp(dot(-ldir, nlu), min=0.0)
        f_rgb = (em.detach() * albedo.detach()[:, None, None, :] / math.pi
                 * (cos_s * cos_l / (dist * dist))[..., None])
        dyd = dy_ds.detach()
        dl = sqrt(dot(dyd, dyd)) / quadrature
        valid = (valid_pe[:, :, None] & inside & ~behind & (sden * sc > 0.0)
                 & (cos_s > 0.0) & (cos_l > 0.0))
        w_q = torch.where(valid, dl, 0.0)[..., None] * f_rgb   # (P, E', S, 3)
    # The non-detached factor: <y(theta), n_dark>.
    lin = (y * (orient[..., None] * n0)).sum(dim=-1, keepdim=True)
    return (w_q * lin).sum(dim=(1, 2))
