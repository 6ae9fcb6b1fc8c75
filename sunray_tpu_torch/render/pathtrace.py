"""Pass 2 — the bounce walk with plain NEE, port of the "nee" and "brdf"
branches of sunray_tpu/render/pathtrace.py (pathtrace.py:98-386).

One closest-hit trace per round over the full batch with masked lanes; a
lane leaves the walk on a miss, emission brightness > 1, throughput death
or Russian roulette. With lighting="nee" every rough bounce within
SHADOW_BOUNCES does next-event estimation (ray_gen_final.slang:328-382).
Round 0 reuses pass 1's stored primary hit instead of re-tracing it.

RNG stream order per round, for every lane whatever its mask:
transmissive_bounce's draw, then NEE u_pick, n1, n2 (nee only), then
ur1, ur2, then u_lobe, then u_rr (pathtrace.py:200-315).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sunray_tpu_torch.camera import generate_rays
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import (
    PI,
    cosine_hemisphere,
    dot,
    reflect,
    sample_ggx_vndf,
    smith_g1_ggx,
    vec_norm,
)
from sunray_tpu_torch.ops.fp import fma
from sunray_tpu_torch.render.gbuffer import (
    _sel3,
    reuse_hit,
    transmissive_bounce,
)
from sunray_tpu_torch.render.shade import shade_hits
from sunray_tpu_torch.render.trace import trace_closest, trace_occluded
from sunray_tpu_torch.utils.bluenoise import NOISE_SIZE, _A1, _A2, noise_texture


@functools.lru_cache(maxsize=8)
def _blue_noise_tiled(w, h):
    """Host-precomputed tiled noise planes (numpy, (H*W,) each)."""
    noise = noise_texture()
    xs = np.arange(w) % NOISE_SIZE
    ys = np.arange(h) % NOISE_SIZE
    bn1 = noise[np.ix_(ys, xs)].reshape(-1)
    bn2 = noise[
        np.ix_((np.arange(h) + 71) % NOISE_SIZE,
               (np.arange(w) + 47) % NOISE_SIZE)
    ].reshape(-1)
    return bn1, bn2


def _blue_noise_rands(cfg, frame_count, device):
    """Per-pixel first-bounce random pair (ray_gen_final.slang:44-50,393-399)."""
    bn1_np, bn2_np = _blue_noise_tiled(cfg.width, cfg.height)
    bn1 = torch.from_numpy(bn1_np).to(device)
    bn2 = torch.from_numpy(bn2_np).to(device)
    fc = torch.remainder(frame_count, 1024).to(torch.float32)
    r1 = torch.remainder(bn1 + fc * _A1, 1.0)
    r2 = torch.remainder(bn2 + fc * _A2, 1.0)
    return r1, r2


def final_pass(scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
               frame_count, first_hit=None):
    """-> (raw HDR color (P, 3), walk rounds). first_hit: pass 1's
    (first_tri, first_t), reused as round 0's hit."""
    w, h = cfg.width, cfg.height
    num_lights = lights.num if lights is not None else 0
    if cfg.lighting == "restir" and num_lights > 0:
        raise NotImplementedError("ReSTIR spatial reuse is not ported")
    if cfg.samples != 1:
        raise NotImplementedError("samples > 1 is not ported")
    use_nee = cfg.lighting == "nee" and num_lights > 0

    p = w * h
    origins, dirs = generate_rays(mats, w, h)
    dev = dirs.device
    origins = origins.reshape(p, 3)
    dirs = dirs.reshape(p, 3)

    pix = torch.arange(p, dtype=torch.int64, device=dev)
    seed = rng_mod.init_seed(pix, frame_count)
    bn_r1, bn_r2 = _blue_noise_rands(cfg, frame_count, dev)

    z3 = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    c = dict(
        i=0,
        seed=seed,
        ray_o=origins,
        ray_d=dirs,
        throughput=torch.ones((p, 3), dtype=torch.float32, device=dev),
        radiance=z3,
        active=torch.ones((p,), dtype=torch.bool, device=dev),
        prev_did_nee=torch.zeros((p,), dtype=torch.bool, device=dev),
    )

    def body(c, reuse=None):
        i = c["i"]
        if reuse is not None:
            hit = reuse_hit(*reuse)
        else:
            hit = trace_closest(tracer, c["ray_o"], c["ray_d"])
        surf = shade_hits(scene, c["ray_o"], c["ray_d"], hit,
                          face_forward=cfg.face_forward_normals)
        live = c["active"] & surf.valid
        roughness = torch.clamp(surf.roughness, min=0.01)
        metallic = torch.clamp(surf.metallic, 0.0, 1.0)

        # Emission pickup unless the previous bounce already did NEE
        # (ray_gen_final.slang:99-104).
        add_em = live & ~c["prev_did_nee"]
        radiance = c["radiance"] + torch.where(
            add_em[:, None], surf.emission * c["throughput"], 0.0
        )
        brightness = surf.emission.amax(dim=-1)
        stop_bright = live & (brightness > 1.0)
        live2 = live & ~stop_bright

        # Transmissive branch (ray_gen_final.slang:106-133).
        trans = live2 & (surf.transmission > 0.5)
        seed2, d_t, o_t, refracted, inside = transmissive_bounce(
            c["seed"], c["ray_d"], surf.normal, surf.ior, surf.pos
        )
        absorb = torch.exp(-(1.0 - surf.albedo) * surf.dist[:, None] * 5.0)
        tp_refr = torch.where(inside[:, None], absorb, surf.albedo)
        tp_trans = torch.where(refracted[:, None], tp_refr, 1.0)
        throughput = torch.where(
            trans[:, None], c["throughput"] * tp_trans, c["throughput"]
        )

        surface = live2 & ~trans
        rough = surface & (roughness > 0.2)

        # Plain NEE branch (ray_gen_final.slang:328-382).
        prev_did_nee = torch.zeros((p,), dtype=torch.bool, device=dev)
        if use_nee:
            nee_lane = rough & (i < cfg.shadow_bounces)
            seed2, u_pick = rng_mod.rnd(seed2)
            lidx = torch.clamp(
                (u_pick * num_lights).to(torch.int32), max=num_lights - 1
            )
            seed2, n1, n2 = rng_mod.rnd2(seed2)
            lpos, lnrm, lem, larea = lights.sample_point(lidx, n1, n2)
            sdir = lpos - surf.pos
            ldist = torch.clamp(vec_norm(sdir), min=1e-6)
            sdir = sdir / ldist[:, None]
            cos_l = torch.clamp(dot(lnrm, -sdir), min=0.0)
            cos_s = torch.clamp(dot(surf.normal, sdir), min=0.0)
            cand = nee_lane & (cos_l > 0.0) & (cos_s > 0.0)
            occ = trace_occluded(
                tracer, surf.pos, sdir, ldist,
                exclude=lights.world_tri[lidx.long()],
            )
            vis = cand & ~occ
            pdf_sa = (ldist * ldist) / torch.clamp(
                cos_l * larea * num_lights, min=1e-4
            )
            contrib = (
                lem * surf.albedo * throughput * cos_s[:, None]
                / (pdf_sa[:, None] * PI)
            )
            contrib = torch.clamp(contrib, max=cfg.nee_contrib_clamp)
            radiance = radiance + torch.where(vis[:, None], contrib, 0.0)
            prev_did_nee = cand

        # BRDF bounce (ray_gen_final.slang:385-427).
        brdf_lane = surface
        n = surf.normal
        v_view = -c["ray_d"]
        f0 = 0.04 * (1.0 - metallic[:, None]) + surf.albedo * metallic[:, None]
        cos_nv = torch.clamp(dot(n, v_view), min=0.0)
        fres = f0 + (1.0 - f0) * torch.clamp(1.0 - cos_nv, 0.0, 1.0)[:, None] ** 5
        p_spec = torch.clamp(fres.amax(dim=-1), 0.05, 1.0)

        seed2, ur1, ur2 = rng_mod.rnd2(seed2)
        r1 = bn_r1 if i == 0 else ur1
        r2 = bn_r2 if i == 0 else ur2

        seed2, u_lobe = rng_mod.rnd(seed2)
        pick_spec = u_lobe < p_spec
        hvec = sample_ggx_vndf(n, v_view, roughness, r1, r2)
        d_spec = reflect(-v_view, hvec)
        spec_ok = dot(n, d_spec) > 0.0
        d_diff = cosine_hemisphere(n, r1, r2)

        ndl_b = torch.clamp(dot(n, d_spec), min=0.001)
        alpha_b = roughness * roughness
        g1 = smith_g1_ggx(ndl_b, alpha_b)
        tp_spec = fres * (g1 / p_spec)[:, None]
        tp_diff = (
            surf.albedo * (1.0 - metallic[:, None]) * (1.0 - fres)
            / torch.clamp(1.0 - p_spec, min=1e-4)[:, None]
        )

        use_spec = pick_spec & spec_ok
        new_d = _sel3(use_spec, d_spec, d_diff)
        tp_mult = torch.where(use_spec[:, None], tp_spec, tp_diff)
        throughput = torch.where(
            brdf_lane[:, None], throughput * tp_mult, throughput
        )
        pmax = throughput.amax(dim=-1)
        die = brdf_lane & (pmax < 0.001)

        seed2, u_rr = rng_mod.rnd(seed2)
        rr_on = brdf_lane & (i > cfg.russian_roulette_start)
        rr_die = rr_on & (u_rr > pmax)
        rr_scale = torch.where(
            (rr_on & ~rr_die)[:, None],
            1.0 / torch.clamp(pmax, min=1e-6)[:, None], 1.0,
        )
        throughput = throughput * rr_scale

        ray_d = _sel3(trans, d_t, _sel3(brdf_lane, new_d, c["ray_d"]))
        ray_o = _sel3(
            trans, o_t,
            _sel3(brdf_lane, fma(surf.normal, 1e-3, surf.pos), c["ray_o"]),
        )
        still = c["active"] & surf.valid & ~stop_bright & ~die & ~rr_die
        return dict(
            i=i + 1,
            seed=seed2,
            ray_o=ray_o,
            ray_d=ray_d,
            throughput=throughput,
            radiance=radiance,
            active=still,
            prev_did_nee=prev_did_nee,
        )

    if cfg.bounces > 0:
        c = body(c, reuse=first_hit)
    while c["i"] < cfg.bounces and bool(c["active"].any()):
        c = body(c)
    # total_radiance = min(radiance, 10) (ray_gen_final.slang:430-431).
    return torch.clamp(c["radiance"], max=cfg.radiance_clamp), c["i"]
