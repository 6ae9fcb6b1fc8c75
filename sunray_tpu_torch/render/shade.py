"""Surface shading at hit points — port of sunray_tpu/render/shade.py.

Barycentric vertex-attribute interpolation, the inverse-transpose normal
transform, texture sampling (base colour, emissive, metallic-roughness),
TBN normal mapping with the handedness of vertex 0 (closest_hit.slang:
12-91). A textureless scene (the static 1x1x1 atlas) has no normal map,
so its TBN block is the identity and its uv columns are dead; both are
skipped, as XLA drops them (shade.py:139-142, 273-279), and its corners
take the (V, 6) position and normal columns. A textured scene's corners
take the full 20-column vertex pack (position, normal, tangent, five uv
sets; shade.py:117-175). K8 (ops/cuda_gather.py) serves the fetches it
serves on the TPU: the (T, 4) triangle pack, the three vertex corners and
the material row of each lane. Multiply-adds round as the reference's do
on the CPU (ops/fp.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sunray_tpu_torch.ops.brdf import (
    bf16_carrier,
    normalize,
    safe_sqrt,
    vec_norm,
)
from sunray_tpu_torch.ops.cuda_gather import gather_rows, take_rows
from sunray_tpu_torch.ops.fp import clip, cross, dot, fma, sum3
from sunray_tpu_torch.ops.texture import sample_texture
from sunray_tpu_torch.scene.types import (
    NULL_TEXTURE,
    TEX_BASE_COLOR,
    TEX_EMISSIVE,
    TEX_METALLIC_ROUGHNESS,
    TEX_NORMAL,
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


def _instance_rows(inst_transform, inst):
    """Each lane's row-major (N, 12) transform and (N, 9) inverse rotation,
    one take_rows of the (I, 21) table (K8 and its backward where the
    transform requires grad, as the material rows)."""
    table = torch.cat([inst_transform.reshape(-1, 12),
                       instance_inverse_rotations(inst_transform)], dim=1)
    rows = take_rows(table, inst)
    return rows[:, :12], rows[:, 12:]


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
    textured = not scene.textures.trivial
    tri = torch.where(hit.hit, hit.tri, 0).to(torch.int32)
    tpack = torch.cat([scene.tri_vidx, scene.tri_inst[:, None]], dim=1)
    tcols = gather_rows(tpack, tri[None])[0]                    # (4, N) int32
    vidx = tcols[0:3].contiguous()                              # (3, N)
    inst = tcols[3].long()
    prim = scene.inst_prim[inst].long()

    cols = [scene.positions, scene.normals]
    if textured:
        cols += [scene.tangents, scene.uvs.reshape(scene.uvs.shape[0], -1)]
    vpack = torch.cat(cols, dim=1)                              # (V, 6 | 20)
    corners = gather_rows(vpack, vidx)                          # (3, C, N)

    xf, inv_rot = _instance_rows(scene.inst_transform, inst)    # (N, 12), (N, 9)

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
    if textured:
        ub, un = 10 + 2 * TEX_BASE_COLOR, 10 + 2 * TEX_NORMAL
        uv = torch.stack([interp(ub), interp(ub + 1)], dim=-1)
        normal_uv = torch.stack([interp(un), interp(un + 1)], dim=-1)
    else:
        uv = normal_uv = None   # dead: every lookup is a fallback

    mats = scene.materials
    mrow = _material_rows(mats, prim)
    tex = mats.tex_index[prim]                                  # (N, 5)
    base_color = sample_texture(scene.textures, tex[:, TEX_BASE_COLOR], uv,
                                mrow["base_color"])
    emissive_factor = mrow["emissive_factor"]                   # (N, 4)
    emissive_sample = sample_texture(
        scene.textures, tex[:, TEX_EMISSIVE], uv,
        torch.cat([emissive_factor[:, :3],
                   torch.ones_like(emissive_factor[:, :1])], dim=-1),
    )
    emission = emissive_sample[:, :3] * emissive_factor[:, 3:4]

    # World normal via inverse-transpose (closest_hit.slang:49-50).
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
    final_normal = world_normal
    if textured:
        final_normal = _normal_map(scene, xf, corners, interp, world_normal,
                                   tex, normal_uv)
    return _finish_surface(scene, orig, d, hit, t_att, mrow, tex, uv,
                           base_color, emission, world_normal, final_normal,
                           face_forward)


def _normal_map(scene, xf, corners, interp, world_normal, tex, normal_uv):
    """The shading normal of a textured scene (shade.py:281-310,
    closest_hit.slang:56-72): the tangent to world, Gram-Schmidt against
    the normal, the bitangent by vertex 0's handedness, the normal map's
    xy with z rebuilt, where the vertex has a tangent and the material a
    normal texture; the world normal elsewhere."""
    t_obj = [interp(6 + j) for j in range(3)]
    handedness = torch.where(corners[0, 9] >= 0.0, 1.0, -1.0)
    has_tangent = vec_norm(torch.stack(t_obj, dim=-1)) > 0.001
    do_nm = has_tangent & (tex[:, TEX_NORMAL] != NULL_TEXTURE)
    wt = normalize(torch.stack(
        [fma(xf[:, 4 * i + 2], t_obj[2],
             fma(xf[:, 4 * i + 0], t_obj[0], xf[:, 4 * i + 1] * t_obj[1]))
         for i in range(3)], dim=-1), eps=1e-12)
    wt = normalize(fma(-dot(wt, world_normal)[:, None], world_normal, wt),
                   eps=1e-12)
    wb = cross(world_normal, wt) * handedness[:, None]
    fallback = torch.tensor([0.5, 0.5, 1.0, 1.0], dtype=torch.float32,
                            device=wt.device).expand(wt.shape[0], 4)
    raw = sample_texture(scene.textures, tex[:, TEX_NORMAL], normal_uv,
                         fallback)[:, :3]
    snm = fma(raw, 2.0, -1.0)
    z = safe_sqrt(clip(1.0 - snm[:, 0] * snm[:, 0] - snm[:, 1] * snm[:, 1],
                       0.0, 1.0))
    snm = normalize(torch.stack([snm[:, 0], snm[:, 1], z], dim=-1), eps=1e-12)
    cols = [(snm[:, k:k + 1], b) for k, b in enumerate((wt, wb, world_normal))]
    mapped = normalize(sum3([c[0] for c in cols], [c[1] for c in cols]),
                       eps=1e-12)
    return torch.where(do_nm[:, None], mapped, world_normal)


# The float columns of the material table, fetched together by K8.
_MATERIAL_COLUMNS = (("base_color", 4), ("emissive_factor", 4),
                     ("roughness", 1), ("metallic", 1), ("transmission", 1),
                     ("ior", 1))


def material_table(mats):
    """The (M, 12) float table of _MATERIAL_COLUMNS, one row a material."""
    return torch.cat([getattr(mats, name).reshape(mats.base_color.shape[0],
                                                  -1)
                      for name, _ in _MATERIAL_COLUMNS], dim=1).contiguous()


def _material_rows(mats, prim):
    """Each lane's material row, {column: (N,) or (N, w)}, in one K8 fetch
    from material_table (the JAX package gathers each column,
    shade.py:234-241, 333-370). Its backward is K8's segment-sum kernel,
    where plain indexing's backward sorts the lanes' indices (~110 ms a
    shade call at 720p on the card)."""
    rows = gather_rows(material_table(mats), prim.to(torch.int32)[None])[0]
    out, c = {}, 0
    for name, width in _MATERIAL_COLUMNS:
        # Row-major (N, w) copies: the layout of what the frame derives
        # from them follows theirs, and the kernels take contiguous rows.
        out[name] = (rows[c] if width == 1
                     else rows[c:c + width].T.contiguous())
        c += width
    return out


def _finish_surface(scene, orig, d, hit, t_att, mrow, tex, uv, base_color,
                    emission, world_normal, final_normal, face_forward):
    """Shared shade_hits tail: metallic-roughness terms, hit position, the
    face-forward flip, and Surface assembly. mrow: _material_rows."""
    mr = sample_texture(scene.textures, tex[:, TEX_METALLIC_ROUGHNESS], uv,
                        torch.ones_like(base_color))
    roughness = mrow["roughness"] * mr[:, 1]   # G channel
    metallic = mrow["metallic"] * mr[:, 2]     # B channel

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
        transmission=mrow["transmission"],
        ior=mrow["ior"],
        valid=hit.hit,
    )


def shading_planes(cfg, normal, v_view, albedo, rough, metal):
    """The target functions' surface attributes in cfg.shading_dtype
    (gbuffer.py:280-295, pathtrace.py:494-501): bfloat16 copies with
    "bf16" (on a differentiable frame the same values as float64 carriers,
    ops/brdf.bf16_carrier, which the target functions read as bf16 only
    with bf16=True from the same cfg.shading_dtype), else the float32
    tensors themselves."""
    attrs = (normal, v_view, albedo, rough, metal)
    if cfg.shading_dtype != "bf16":
        return attrs
    if cfg.differentiable:
        return tuple(bf16_carrier(x) for x in attrs)
    return tuple(x.to(torch.bfloat16) for x in attrs)
