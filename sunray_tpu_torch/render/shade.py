"""Surface shading at hit points — port of sunray_tpu/render/shade.py on
the trivial-atlas path (shade.py:135-137, :273-279).

Barycentric vertex-attribute interpolation, the inverse-transpose normal
transform and the metallic-roughness material terms (closest_hit.slang:
12-91). A textureless scene has no normal map, so the TBN block is the
identity and the uv columns are dead; both are skipped, as XLA drops them
(shade.py:139-142). K8 (ops/cuda_gather.py) serves the two fetches it
serves on the TPU: the (T, 4) triangle pack and the three vertex corners
from the (V, 6) geometry columns. Multiply-adds round as the reference's
do on the CPU (ops/fp.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sunray_tpu_torch.ops.brdf import normalize
from sunray_tpu_torch.ops.cuda_gather import gather_rows
from sunray_tpu_torch.ops.fp import cross, dot, fma
from sunray_tpu_torch.ops.texture import sample_texture
from sunray_tpu_torch.scene.types import (
    TEX_BASE_COLOR,
    TEX_EMISSIVE,
    TEX_METALLIC_ROUGHNESS,
)


class Surface(NamedTuple):
    """Batched shading result (the RayPayload analog, unpacked)."""

    dist: torch.Tensor          # (N,)
    pos: torch.Tensor           # (N, 3) world hit position
    normal: torch.Tensor        # (N, 3) shading normal
    geo_normal: torch.Tensor    # (N, 3) interpolated geometric normal
    albedo: torch.Tensor        # (N, 3)
    emission: torch.Tensor      # (N, 3)
    roughness: torch.Tensor     # (N,)
    metallic: torch.Tensor      # (N,)
    transmission: torch.Tensor  # (N,)
    ior: torch.Tensor           # (N,)
    valid: torch.Tensor         # (N,) bool — hit mask


def instance_inverse_rotations(inst_transform):
    """(I, 9) row-major inverse of each (3, 3) rotation/scale block, by the
    adjugate (no library solver, no host sync)."""
    m = inst_transform[:, :, :3]
    c0, c1, c2 = m[:, :, 0], m[:, :, 1], m[:, :, 2]
    # Rows of the inverse are the cross products of the columns / det.
    r0 = cross(c1, c2)
    r1 = cross(c2, c0)
    r2 = cross(c0, c1)
    det = dot(c0, r0)
    inv = torch.stack([r0, r1, r2], dim=1) / det[:, None, None]
    return inv.reshape(-1, 9)


def _recompute_hit(orig, d, w0, w1, w2):
    """Moller-Trumbore (t, u, v) for known winning world triangles, one
    (N, 3) tensor per corner."""
    e1 = w1 - w0
    e2 = w2 - w0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    det_ok = det.abs() > 1e-9
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    tvec = orig - w0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    return t, u, v


def shade_hits(scene, orig, d, hit, face_forward=False) -> Surface:
    """Surface for a batch of hits. orig/d: (N, 3); hit: intersect.Hit.
    Misses produce valid=False with dist=-1 (ray_miss.slang:9-13).

    face_forward: flip the shading and geometric normal to face the
    incoming ray (cfg.face_forward_normals)."""
    if not scene.textures.trivial:
        raise NotImplementedError("shade_hits: textured atlases are not ported")
    tri = torch.where(hit.hit, hit.tri, 0).to(torch.int32)
    tpack = torch.cat([scene.tri_vidx, scene.tri_inst[:, None]], dim=1)
    tcols = gather_rows(tpack, tri[None])[0]                    # (4, N) int32
    vidx = tcols[0:3].contiguous()                              # (3, N)
    inst = tcols[3].long()
    prim = scene.inst_prim[inst].long()

    vgeo = torch.cat([scene.positions, scene.normals], dim=1)   # (V, 6)
    corners = gather_rows(vgeo, vidx)                           # (3, 6, N)

    xf = scene.inst_transform.reshape(-1, 12)[inst]             # (N, 12)

    def to_world(c):
        return torch.stack(
            [
                fma(xf[:, 4 * i + 2], c[2],
                    fma(xf[:, 4 * i + 0], c[0], xf[:, 4 * i + 1] * c[1]))
                + xf[:, 4 * i + 3]
                for i in range(3)
            ],
            dim=-1,
        )

    w0, w1, w2 = (to_world(corners[k]) for k in range(3))
    t_d, u_d, v_d = _recompute_hit(orig, d, w0, w1, w2)
    t_att = torch.where(hit.hit, t_d, hit.t)
    u = torch.where(hit.hit, u_d, hit.u)
    v = torch.where(hit.hit, v_d, hit.v)
    bw = (1.0 - u - v, u, v)

    def interp(o):
        return fma(bw[2], corners[2, o],
                   fma(bw[0], corners[0, o], bw[1] * corners[1, o]))

    n_obj = [interp(3 + i) for i in range(3)]

    mats = scene.materials
    tex = mats.tex_index[prim]                                  # (N, 5)
    base_color = sample_texture(scene.textures, tex[:, TEX_BASE_COLOR],
                                mats.base_color[prim])
    emissive_factor = mats.emissive_factor[prim]                # (N, 4)
    emissive_sample = sample_texture(
        scene.textures, tex[:, TEX_EMISSIVE],
        torch.cat([emissive_factor[:, :3],
                   torch.ones_like(emissive_factor[:, :1])], dim=-1),
    )
    emission = emissive_sample[:, :3] * emissive_factor[:, 3:4]

    # World normal via inverse-transpose (closest_hit.slang:49-50).
    inv_rot = instance_inverse_rotations(scene.inst_transform)[inst]  # (N, 9)
    world_normal = normalize(
        torch.stack(
            [
                fma(inv_rot[:, 6 + j], n_obj[2],
                    fma(inv_rot[:, j], n_obj[0], inv_rot[:, 3 + j] * n_obj[1]))
                for j in range(3)
            ],
            dim=-1,
        ),
        eps=1e-12,
    )
    return _finish_surface(scene, orig, d, hit, t_att, prim, tex, base_color,
                           emission, world_normal, world_normal, face_forward)


def _finish_surface(scene, orig, d, hit, t_att, prim, tex, base_color,
                    emission, world_normal, final_normal, face_forward):
    """Shared shade_hits tail: metallic-roughness terms, hit position, the
    face-forward flip, and Surface assembly."""
    mats = scene.materials
    mr = sample_texture(scene.textures, tex[:, TEX_METALLIC_ROUGHNESS],
                        torch.ones_like(base_color))
    roughness = mats.roughness[prim] * mr[:, 1]   # G channel
    metallic = mats.metallic[prim] * mr[:, 2]     # B channel

    dist = torch.where(hit.hit, t_att, -1.0)
    pos = fma(d, dist[:, None], orig)

    if face_forward:
        back = (dot(world_normal, d) > 0.0) & hit.hit
        sgn = torch.where(back, -1.0, 1.0)[:, None]
        final_normal = final_normal * sgn
        world_normal = world_normal * sgn

    return Surface(
        dist=dist,
        pos=pos,
        normal=final_normal,
        geo_normal=world_normal,
        albedo=base_color[:, :3],
        emission=emission,
        roughness=roughness,
        metallic=metallic,
        transmission=mats.transmission[prim],
        ior=mats.ior[prim],
        valid=hit.hit,
    )
