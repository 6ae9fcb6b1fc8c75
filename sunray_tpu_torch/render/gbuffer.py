"""Pass 1 — primary walk, G-buffer, ReSTIR DI audition and the GI initial
sample; port of sunray_tpu/render/gbuffer.py.

  phase 1: the virtual-bounce walk (glass/mirror passthrough to the first
           diffuse surface, ray_gen_ris.slang:69-141) as a Python loop
           over full ray batches with an active mask: the peeled first
           round always runs, then rounds continue while
           i < virtual_bounces and any lane is active
           (ops/loops.bounded_loop; on a differentiable frame each
           looped round is recomputed in the backward pass);
  phase 2: RIS audition (K3), DI temporal reuse (K4) and the winner's
           visibility ray (ray_gen_ris.slang:174-302);
  phase 3: the GI initial sample, one cosine bounce with NEE at its hit,
           and GI temporal reuse (ray_gen_ris.slang:311-439).

The DI visibility ray and the GI NEE shadow ray go to the tracer in one
2P-ray call (gbuffer.py:354-366). Per pixel the RNG stream runs: walk,
audition (4K draws), DI jitter (2), DI merge (1), GI bounce (2), NEE pick
and point (3), GI jitter (2), GI merge (1).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sunray_tpu_torch.camera import (
    generate_rays,
    pixel_centers,
    pixel_rows,
    project_to_prev_uv,
)
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import (
    INV_PI,
    PI,
    cosine_hemisphere,
    dot,
    gi_target_pdf,
    reflect,
    refract,
    vec_norm,
)
from sunray_tpu_torch.ops.fp import clip, fma, pow5
from sunray_tpu_torch.ops.intersect import Hit
from sunray_tpu_torch.ops.loops import bounded_loop
from sunray_tpu_torch.render import restir
from sunray_tpu_torch.render.shade import shade_hits, shading_planes
from sunray_tpu_torch.render.trace import trace_closest, trace_occluded

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
    fresnel = r0 + (1.0 - r0) * pow5(1.0 - cos_theta)
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
        # Rounds after the peeled first one are incoherent (gbuffer.py:199).
        hit = trace_closest(tracer, c["ray_o"], c["ray_d"], coherent=first)
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
        metallic = clip(surf.metallic, 0.0, 1.0)
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

    # peel: the camera round always runs (gbuffer.py:197-200).
    return bounded_loop(
        lambda c: c["i"] < cfg.virtual_bounces and bool(c["active"].any()),
        lambda c: body(c, first=True), c, cfg.virtual_bounces,
        cfg.differentiable, peel=1,
        loop_body=lambda c: body(c, first=False))


def ris_pass(scene, cfg, tracer, lights, mats, prev_view_proj,
             res_di_hist, res_gi_hist, frame_count, grid=None):
    """Full pass 1. Returns (GBuffer, ReservoirDI, ReservoirGI, PrimaryHit,
    walk rounds); the reservoirs are empty unless lighting is "restir".

    grid (parallel/halo.ShardGrid): a row-sharded frame (gbuffer.py:
    206-219) — every per-pixel array covers the band's rows; pixel ids,
    uv and the reprojection stay GLOBAL (so each band equals those rows of
    the single-device pass), and the temporal history reads go through
    the halo exchange."""
    w, h = cfg.width, cfg.height
    if grid is not None:
        hl, row0 = grid.hl, grid.row0
        origins, dirs = generate_rays(mats, w, h, row0=row0, rows=hl)
    else:
        hl, row0 = h, None
        origins, dirs = generate_rays(mats, w, h)
    p = w * hl
    dev = dirs.device
    origins = origins.reshape(p, 3)
    dirs = dirs.reshape(p, 3)

    pix = torch.arange(p, dtype=torch.int64, device=dev) + (row0 or 0) * w
    seed = rng_mod.init_seed(pix, frame_count)

    walk = primary_walk(scene, cfg, tracer, origins, dirs, seed)
    seed = walk["seed"]
    found = walk["found"]

    # Reprojection + motion vectors (ray_gen_ris.slang:118-136).
    vv, uu = torch.meshgrid(pixel_rows(h, dev, row0, hl),
                            pixel_centers(w, dev), indexing="ij")
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
    if cfg.lighting != "restir" or lights is None or lights.num == 0:
        return (gbuf, restir.ReservoirDI.empty(p, dev),
                restir.ReservoirGI.empty(p, dev), hitd, walk["i"])
    r_di, r_gi = _restir_samples(scene, cfg, tracer, lights, seed, hitd,
                                 res_di_hist, res_gi_hist, frame_count, grid)
    return gbuf, r_di, r_gi, hitd, walk["i"]


def _restir_samples(scene, cfg, tracer, lights, seed, hitd: PrimaryHit,
                    res_di_hist, res_gi_hist, frame_count, grid=None):
    """Phases 2 and 3 of pass 1: the DI and GI reservoirs of this frame."""
    w, h = cfg.width, cfg.height
    p = hitd.found.shape[0]
    found = hitd.found
    pos, normal = hitd.pos, hitd.normal
    # The target functions read the attributes in cfg.shading_dtype
    # (gbuffer.py:280-295); rays and the confidence tests take float32.
    normal_s, view_s, albedo_s, rough_s, metal_s = shading_planes(
        cfg, normal, hitd.v_view, hitd.albedo, hitd.roughness, hitd.metallic)
    attrs = (view_s, albedo_s, rough_s, metal_s)

    # --- Phase 2: RIS + temporal + visibility (DI) ---
    enable_di = found & (hitd.roughness > 0.2)
    # A differentiable frame keeps JAX's jnp audition (gbuffer.py:295):
    # K3 routes no gradient.
    seed, r_di = restir.ris_audition(lights, seed, pos, normal_s, *attrs,
                                     cfg.ris_candidates, enable_di,
                                     kernel=not cfg.differentiable,
                                     bf16=cfg.shading_dtype == "bf16")
    if cfg.history_joint_gather:
        # One shared reprojection and one gather for the DI and GI
        # histories (gbuffer.py:305-313); the GI merge reuses pre_gi.
        seed, h_di, h_gi, base_ok = restir.gather_temporal_histories(
            cfg, seed, res_di_hist, res_gi_hist, hitd.prev_uv,
            hitd.prev_valid, frame_count, w, h, grid=grid)
        pre_di, pre_gi = (h_di, base_ok), (h_gi, base_ok)
    else:
        pre_di = pre_gi = None
    seed, r_di = restir.di_temporal_reuse(
        lights, cfg, seed, r_di, res_di_hist, hitd.prev_uv, hitd.prev_valid,
        frame_count, pos, normal_s, *attrs, hitd.virtual_distance, w, h,
        enable_di, pregathered=pre_di, grid=grid,
    )
    # Visibility reuse (ray_gen_ris.slang:277-302), traced below together
    # with the GI NEE shadow ray.
    vis_vec = r_di.light_pos - pos
    vis_dist = torch.clamp(vec_norm(vis_vec), min=1e-4)
    vis_dir = vis_vec / vis_dist[:, None]
    facing = dot(normal, vis_dir) > 0.0
    vis_origin = fma(normal, 1e-3, pos)
    vis_exclude = lights.world_tri[r_di.light_idx.long()]

    # --- Phase 3: GI initial sample (ray_gen_ris.slang:311-406) ---
    seed, g1, g2 = rng_mod.rnd2(seed)
    gi_dir = cosine_hemisphere(normal, g1, g2)
    gi_ndl = torch.clamp(dot(normal, gi_dir), min=0.0)
    gi_enable = found & (gi_ndl > 0.0)
    gi_origin = fma(normal, 1e-3, pos)
    gi_hit = trace_closest(tracer, gi_origin, gi_dir, coherent=False)
    gi_surf = shade_hits(scene, gi_origin, gi_dir, gi_hit,
                         face_forward=cfg.face_forward_normals)
    gi_found = gi_enable & gi_surf.valid & (gi_surf.dist > 0.0)
    g3 = gi_found[:, None]
    sample_pos = torch.where(g3, gi_surf.pos, 0.0)
    sample_normal = torch.where(g3, gi_surf.normal, 0.0)
    sample_radiance = torch.where(g3, gi_surf.emission, 0.0)

    # NEE at x2 (ray_gen_ris.slang:344-391).
    seed, u_pick = rng_mod.rnd(seed)
    nee_idx = torch.clamp((u_pick * lights.num).to(torch.int32),
                          max=lights.num - 1)
    seed, n1, n2 = rng_mod.rnd2(seed)
    nee_pos, nee_normal, nee_em, nee_area = lights.sample_point(nee_idx, n1,
                                                                n2)
    to_light = nee_pos - sample_pos
    nee_dist = torch.clamp(vec_norm(to_light), min=1e-4)
    to_light = to_light / nee_dist[:, None]
    nee_cos_surf = torch.clamp(dot(sample_normal, to_light), min=0.0)
    nee_cos_light = torch.clamp(dot(nee_normal, -to_light), min=0.0)
    nee_try = gi_found & (nee_cos_surf > 0.0) & (nee_cos_light > 0.0)
    occ2 = trace_occluded(
        tracer,
        torch.cat([vis_origin, fma(sample_normal, 1e-3, sample_pos)]),
        torch.cat([vis_dir, to_light]),
        torch.cat([vis_dist, nee_dist]),
        exclude=torch.cat([vis_exclude, lights.world_tri[nee_idx.long()]]),
        coherent=False,
    )
    keep_w = (r_di.W > 0.0) & facing & ~occ2[:p]
    r_di = dataclasses.replace(
        r_di, W=torch.where(keep_w, r_di.W, 0.0),
        hit_normal=torch.where(found[:, None], normal, 0.0),
        depth=hitd.virtual_distance,
    )
    r_di = restir.sky_emptied(r_di, found)

    nee_ok = nee_try & ~occ2[p:]
    nee_pdf_sa = (nee_dist * nee_dist) / torch.clamp(
        nee_cos_light * nee_area * lights.num, min=1e-4)
    nee_contrib = (nee_em * gi_surf.albedo * nee_cos_surf[:, None]
                   / (nee_pdf_sa[:, None] * PI))
    sample_radiance = torch.clamp(
        sample_radiance + torch.where(nee_ok[:, None], nee_contrib, 0.0),
        max=cfg.gi_radiance_clamp)

    p_hat = gi_target_pdf(pos, normal_s, albedo_s, metal_s, sample_pos,
                          sample_radiance, bf16=cfg.shading_dtype == "bf16")
    pdf = gi_ndl * INV_PI
    w_sum = torch.where(pdf > 0.0, p_hat / torch.clamp(pdf, min=1e-9), 0.0)
    r_gi = restir.ReservoirGI(
        sample_pos=sample_pos,
        w_sum=torch.where(gi_enable, w_sum, 0.0),
        sample_radiance=sample_radiance,
        M=torch.where(gi_enable, 1.0, 0.0),
        sample_normal=sample_normal,
        W=torch.where(gi_enable & (p_hat > 0.0),
                      w_sum / torch.clamp(p_hat, min=1e-9), 0.0),
        hit_normal=torch.zeros_like(sample_pos),
        depth=torch.zeros_like(p_hat),
        sample_tri=torch.where(gi_found, gi_hit.tri, -1).to(torch.int32),
    )
    seed, r_gi = restir.gi_temporal_reuse(
        cfg, seed, r_gi, res_gi_hist, hitd.prev_uv, hitd.prev_valid,
        frame_count, pos, normal_s, albedo_s, metal_s,
        hitd.virtual_distance, w, h, found, pregathered=pre_gi, grid=grid,
    )
    r_gi = dataclasses.replace(
        r_gi, hit_normal=torch.where(found[:, None], normal, 0.0),
        depth=hitd.virtual_distance,
    )
    return r_di, restir.sky_emptied(r_gi, found)
