"""Pass 1 — primary walk + G-buffer, port of sunray_tpu/render/gbuffer.py
up to ris_pass's non-ReSTIR return (gbuffer.py:276-277).

The virtual-bounce walk (glass/mirror passthrough to the first diffuse
surface, ray_gen_ris.slang:69-141) runs as a Python loop over full ray
batches with an active mask: the peeled first round always runs, then
rounds continue while i < virtual_bounces and any lane is active
(ops/loops.bounded_loop's forward semantics). The RIS audition and the DI
/ GI temporal reuse are the next port slice and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sunray_tpu_torch.camera import (
    generate_rays,
    pixel_centers,
    project_to_prev_uv,
)
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import dot, reflect, refract, vec_norm
from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.ops.intersect import Hit
from sunray_tpu_torch.render import restir
from sunray_tpu_torch.render.shade import shade_hits
from sunray_tpu_torch.render.trace import trace_closest

SKY_DEPTH = 100000.0  # ray_gen_ris.slang:155 sentinel


class GBuffer(NamedTuple):
    """Flat (P,) G-buffer (depth/normal/diffuse/motion images of pass 1)."""

    depth: torch.Tensor      # (P,)
    normal: torch.Tensor     # (P, 3)
    roughness: torch.Tensor  # (P,)
    diffuse: torch.Tensor    # (P, 3) demodulation albedo lerp(albedo, 1, metallic)
    motion: torch.Tensor     # (P, 2)


class PrimaryHit(NamedTuple):
    """First-diffuse-surface data of the primary walk."""

    found: torch.Tensor              # (P,) bool
    pos: torch.Tensor                # (P, 3)
    normal: torch.Tensor             # (P, 3)
    albedo: torch.Tensor             # (P, 3)
    roughness: torch.Tensor          # (P,)
    metallic: torch.Tensor           # (P,)
    v_view: torch.Tensor             # (P, 3)
    first_tri: torch.Tensor          # (P,) raw first-hit triangle (-1 miss)
    first_t: torch.Tensor            # (P,) raw first-hit distance (1e9 miss)
    virtual_distance: torch.Tensor   # (P,)
    prev_uv: torch.Tensor            # (P, 2)
    prev_valid: torch.Tensor         # (P,)


def _sel3(m, a, b):
    return torch.where(m[:, None], a, b)


def transmissive_bounce(seed, ray_d, surf_normal, surf_ior, surf_pos):
    """Glass interaction (ray_gen_ris.slang:95-114). Returns (seed, new_dir,
    new_origin, was_refracted, is_inside). Draws one number for every lane."""
    is_inside = dot(ray_d, surf_normal) > 0.0
    n = torch.where(is_inside[:, None], -surf_normal, surf_normal)
    ior = torch.clamp(surf_ior, min=1.0)
    eta = torch.where(is_inside, ior, 1.0 / ior)
    cos_theta = torch.clamp(dot(-ray_d, n), max=1.0)
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    fresnel = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    refracted = refract(ray_d, n, eta)
    tir = vec_norm(refracted) < 0.01
    fresnel = torch.where(tir, 1.0, fresnel)
    seed, u = rng_mod.rnd(seed)
    reflects = u < fresnel
    new_d = _sel3(reflects, reflect(ray_d, n), refracted)
    new_o = fma(new_d, 1e-3, surf_pos)
    return seed, new_d, new_o, ~reflects, is_inside


def reuse_hit(first_tri, first_t) -> Hit:
    """The Hit that a stored (first_tri, first_t) stands for. u/v are zeros:
    shade_hits recomputes them for hit lanes and never reads them for misses
    (gbuffer.py:126-143, pathtrace.py:159-178)."""
    hm = first_tri >= 0
    return Hit(
        t=torch.where(hm, first_t, torch.inf),
        tri=torch.clamp(first_tri, min=0),
        u=torch.zeros_like(first_t),
        v=torch.zeros_like(first_t),
        hit=hm,
    )


def primary_walk(scene, cfg, tracer, origins, dirs, seed):
    """Phase 1: walk to the first diffuse surface. Returns the final carry
    dict (seed, found, pos, normal, ..., first_tri, first_t, i)."""
    p = origins.shape[0]
    dev = origins.device
    z3 = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    z = torch.zeros((p,), dtype=torch.float32, device=dev)
    c = dict(
        i=0,
        seed=seed,
        ray_o=origins,
        ray_d=dirs,
        active=torch.ones((p,), dtype=torch.bool, device=dev),
        found=torch.zeros((p,), dtype=torch.bool, device=dev),
        virtual_distance=z,
        pos=z3,
        normal=z3,
        albedo=z3,
        roughness=torch.full((p,), 0.5, device=dev),
        metallic=z,
        v_view=z3,
        first_tri=torch.full((p,), -1, dtype=torch.int32, device=dev),
        first_t=torch.full((p,), 1e9, dtype=torch.float32, device=dev),
    )

    def body(c, first):
        hit = trace_closest(tracer, c["ray_o"], c["ray_d"])
        tri0 = torch.where(hit.hit, hit.tri, -1)
        t0 = torch.where(hit.hit, hit.t, 1e9)
        if first:
            # Shade round 0 through the hit rebuilt from (first_tri,
            # first_t), the same expression the final pass's reused round
            # shades (gbuffer.py:126-143).
            hit = reuse_hit(tri0, t0)
        surf = shade_hits(scene, c["ray_o"], c["ray_d"], hit,
                          face_forward=cfg.face_forward_normals)
        live = c["active"] & surf.valid
        miss = c["active"] & ~surf.valid

        roughness = torch.clamp(surf.roughness, min=0.01)
        metallic = torch.clamp(surf.metallic, 0.0, 1.0)
        vd = c["virtual_distance"] + torch.where(live, surf.dist, 0.0)

        transmissive = live & (surf.transmission > 0.5)
        mirror = live & ~transmissive & (metallic > 0.9) & (roughness < 0.1)
        diffuse = live & ~transmissive & ~mirror

        seed, d_trans, o_trans, _, _ = transmissive_bounce(
            c["seed"], c["ray_d"], surf.normal, surf.ior, surf.pos
        )
        d_mir = reflect(c["ray_d"], surf.normal)
        o_mir = fma(surf.normal, 1e-3, surf.pos)

        ray_d = _sel3(transmissive, d_trans, _sel3(mirror, d_mir, c["ray_d"]))
        ray_o = _sel3(transmissive, o_trans, _sel3(mirror, o_mir, c["ray_o"]))

        rec = diffuse  # lanes recording their first diffuse surface
        return dict(
            i=c["i"] + 1,
            seed=seed,
            ray_o=ray_o,
            ray_d=ray_d,
            active=c["active"] & ~miss & ~diffuse,
            found=c["found"] | diffuse,
            virtual_distance=vd,
            pos=_sel3(rec, surf.pos, c["pos"]),
            normal=_sel3(rec, surf.normal, c["normal"]),
            albedo=_sel3(rec, surf.albedo, c["albedo"]),
            roughness=torch.where(rec, roughness, c["roughness"]),
            metallic=torch.where(rec, metallic, c["metallic"]),
            v_view=_sel3(rec, -c["ray_d"], c["v_view"]),
            first_tri=tri0 if first else c["first_tri"],
            first_t=t0 if first else c["first_t"],
        )

    if cfg.virtual_bounces > 0:
        c = body(c, first=True)
    while c["i"] < cfg.virtual_bounces and bool(c["active"].any()):
        c = body(c, first=False)
    return c


def ris_pass(scene, cfg, tracer, lights, mats, prev_view_proj,
             res_di_hist, res_gi_hist, frame_count):
    """Pass 1 up to the G-buffer. Returns (GBuffer, ReservoirDI,
    ReservoirGI, PrimaryHit, walk rounds). ReSTIR lighting raises."""
    if cfg.lighting == "restir" and lights is not None and lights.num > 0:
        raise NotImplementedError(
            "ReSTIR lighting (RIS audition, temporal reuse) is not ported; "
            "use lighting='nee' or 'brdf'"
        )
    w, h = cfg.width, cfg.height
    p = w * h
    origins, dirs = generate_rays(mats, w, h)
    dev = dirs.device
    origins = origins.reshape(p, 3)
    dirs = dirs.reshape(p, 3)

    pix = torch.arange(p, dtype=torch.int64, device=dev)
    seed = rng_mod.init_seed(pix, frame_count)

    walk = primary_walk(scene, cfg, tracer, origins, dirs, seed)
    found = walk["found"]

    # Reprojection + motion vectors (ray_gen_ris.slang:118-136).
    vv, uu = torch.meshgrid(pixel_centers(h, dev), pixel_centers(w, dev),
                            indexing="ij")
    in_uv = torch.stack([uu, vv], dim=-1).reshape(p, 2)

    virtual_pos = origins + dirs * walk["virtual_distance"][:, None]
    prev_uv, prev_valid = project_to_prev_uv(prev_view_proj, virtual_pos)
    motion = torch.where(prev_valid[:, None], in_uv - prev_uv, in_uv + 2.0)

    f3 = found[:, None]
    gbuf = GBuffer(
        depth=torch.where(found, walk["virtual_distance"], SKY_DEPTH),
        normal=torch.where(f3, walk["normal"], 0.0),
        roughness=torch.where(found, walk["roughness"], 0.0),
        diffuse=torch.where(
            f3,
            walk["albedo"] * (1.0 - walk["metallic"][:, None])
            + walk["metallic"][:, None],
            0.0,
        ),
        motion=torch.where(f3, motion, 0.0),
    )
    hitd = PrimaryHit(
        found=found,
        pos=walk["pos"],
        normal=walk["normal"],
        albedo=walk["albedo"],
        roughness=walk["roughness"],
        metallic=walk["metallic"],
        v_view=walk["v_view"],
        first_tri=walk["first_tri"],
        first_t=walk["first_t"],
        virtual_distance=walk["virtual_distance"],
        prev_uv=prev_uv,
        prev_valid=prev_valid,
    )
    return (gbuf, restir.ReservoirDI.empty(p, dev),
            restir.ReservoirGI.empty(p, dev), hitd, walk["i"])
