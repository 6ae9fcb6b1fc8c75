"""Pass 2 — the bounce walk with ReSTIR DI/GI spatial reuse or plain NEE;
port of sunray_tpu/render/pathtrace.py.

  phase A: the bounce walk. One closest-hit trace per round over the full
           batch with masked lanes; a lane leaves the walk on a miss,
           emission brightness > 1, throughput death, Russian roulette,
           or, with ReSTIR, at its first rough hit within SHADOW_BOUNCES:
           that hit's surface is frozen for phase B. With lighting="nee"
           every rough bounce within SHADOW_BOUNCES does next-event
           estimation (ray_gen_final.slang:328-382). Round 0 reuses pass
           1's stored primary hit instead of re-tracing it.
  phase B: ReSTIR DI spatial reuse (K5) and GI spatial reuse (tap prep
           with one T*P-ray visibility call, then K6) at the frozen hits
           (ray_gen_final.slang:136-327), with shared tap offsets
           (cfg.spatial_taps="shared"), or with each pixel's own disc
           taps in plain PyTorch (any other value: the reference-exact
           estimator, jnp in JAX too; one visibility call a GI tap),
           and one 2P-ray call for the DI winner and the GI final
           visibility. The target functions read the surface
           attributes in cfg.shading_dtype (render/shade.shading_planes).

RNG stream order per round, for every lane whatever its mask:
transmissive_bounce's draw, then NEE u_pick, n1, n2 (nee only), then
ur1, ur2, then u_lobe, then u_rr (pathtrace.py:200-315). Phase B then
draws the DI centre merge (1), the DI taps (rnd_chain(T_di)) and the GI
taps (rnd_chain(T_gi)); with per-pixel taps each tap draws its offset
(2), then its merge (1), DI taps first.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from sunray_tpu_torch.camera import generate_rays
from sunray_tpu_torch.ops import cuda_restir, fp
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import (
    PI,
    cosine_hemisphere,
    dot,
    gi_target_pdf,
    reflect,
    sample_ggx_vndf,
    smith_g1_ggx,
    vec_norm,
)
from sunray_tpu_torch.ops.cuda_restir import neighbour_ok, shift_window
from sunray_tpu_torch.ops.fp import clip, dot3, fma, pow5, sqrt
from sunray_tpu_torch.ops.loops import bounded_loop, checkpointed
from sunray_tpu_torch.parallel.halo import exchange_flat_many, window_index
from sunray_tpu_torch.render import boundary
from sunray_tpu_torch.render.gbuffer import (
    _sel3,
    reuse_hit,
    transmissive_bounce,
)
from sunray_tpu_torch.render.shade import shade_hits, shading_planes
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


def _blue_noise_rands(cfg, frame_count, device, grid=None):
    """Per-pixel first-bounce random pair (ray_gen_final.slang:44-50,393-399).
    grid: the band's rows, global rows modulo the noise size
    (pathtrace.py:77-95)."""
    bn1_np, bn2_np = _blue_noise_tiled(cfg.width, cfg.height)
    if grid is not None:
        band = slice(grid.row0 * cfg.width, (grid.row0 + grid.hl) * cfg.width)
        bn1_np, bn2_np = bn1_np[band], bn2_np[band]
    bn1 = torch.from_numpy(bn1_np).to(device)
    bn2 = torch.from_numpy(bn2_np).to(device)
    fc = torch.remainder(frame_count, 1024).to(torch.float32)
    r1 = torch.remainder(bn1 + fc * _A1, 1.0)
    r2 = torch.remainder(bn2 + fc * _A2, 1.0)
    return r1, r2


def final_pass(scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
               frame_count, sample_idx=0, first_hit=None, grid=None):
    """-> (raw HDR color (P, 3), walk rounds). first_hit: pass 1's
    (first_tri, first_t), reused as round 0's hit. sample_idx: which of
    cfg.samples final passes this is; with samples > 1 the PCG stream is
    seeded by frame_count * samples + sample_idx (uint32, wrapping;
    pathtrace.py:131-136), samples == 1 keeps the frame's own stream. The
    blue-noise first-bounce pair takes the unsalted frame_count, so every
    sample sees the same blue noise (pathtrace.py:137). grid: a row-sharded frame
    (pathtrace.py:103-137): the band's rays, global pixel seeds and noise
    rows, and spatial reuse through the halo exchange."""
    w, h = cfg.width, cfg.height
    num_lights = lights.num if lights is not None else 0
    use_restir = cfg.lighting == "restir" and num_lights > 0
    use_nee = cfg.lighting == "nee" and num_lights > 0

    if grid is not None:
        p = w * grid.hl
        origins, dirs = generate_rays(mats, w, h, row0=grid.row0,
                                      rows=grid.hl)
    else:
        p = w * h
        origins, dirs = generate_rays(mats, w, h)
    dev = dirs.device
    origins = origins.reshape(p, 3)
    dirs = dirs.reshape(p, 3)

    pix = torch.arange(p, dtype=torch.int64, device=dev) + _pix0(grid, w)
    fc = frame_count
    if cfg.samples > 1:
        fc = rng_mod.salt(frame_count, cfg.samples, sample_idx)
    seed = rng_mod.init_seed(pix, fc)
    bn_r1, bn_r2 = _blue_noise_rands(cfg, frame_count, dev, grid)

    z3 = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    z = torch.zeros((p,), dtype=torch.float32, device=dev)
    c = dict(
        i=0,
        seed=seed,
        ray_o=origins,
        ray_d=dirs,
        throughput=torch.ones((p, 3), dtype=torch.float32, device=dev),
        radiance=z3,
        active=torch.ones((p,), dtype=torch.bool, device=dev),
        prev_did_nee=torch.zeros((p,), dtype=torch.bool, device=dev),
        # frozen first-rough-hit state for phase B
        pending=torch.zeros((p,), dtype=torch.bool, device=dev),
        f_pos=z3, f_normal=z3, f_albedo=z3, f_rough=z, f_metal=z,
        f_view=z3, f_throughput=z3,
    )

    def body(c, reuse=None, coherent=True, first=False):
        i = c["i"]
        if reuse is not None:
            hit = reuse_hit(*reuse)
        else:
            hit = trace_closest(tracer, c["ray_o"], c["ray_d"],
                                coherent=coherent)
        surf = shade_hits(scene, c["ray_o"], c["ray_d"], hit,
                          face_forward=cfg.face_forward_normals)
        live = c["active"] & surf.valid
        roughness = torch.clamp(surf.roughness, min=0.01)
        metallic = clip(surf.metallic, 0.0, 1.0)

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

        # ReSTIR trigger: freeze and leave the walk.
        trigger = torch.zeros((p,), dtype=torch.bool, device=dev)
        if use_restir:
            trigger = rough & ~c["pending"] & (i < cfg.shadow_bounces)

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
            if first and cfg.shadow_boundary_grads and cfg.differentiable:
                # Visibility boundary gradients (render/boundary.py): zero
                # in the forward pass, the silhouette-edge boundary
                # integral of this NEE estimator in the backward pass.
                radiance = radiance + _boundary_term(
                    cfg, scene, lights, surf.pos, surf.normal, surf.albedo,
                    nee_lane) * throughput.detach()

        # BRDF bounce (ray_gen_final.slang:385-427) for surface lanes that
        # did not trigger ReSTIR.
        brdf_lane = surface & ~trigger
        n = surf.normal
        v_view = -c["ray_d"]
        f0 = 0.04 * (1.0 - metallic[:, None]) + surf.albedo * metallic[:, None]
        cos_nv = torch.clamp(dot(n, v_view), min=0.0)
        fres = f0 + (1.0 - f0) * pow5(torch.clamp(1.0 - cos_nv, 0.0, 1.0))[:, None]
        p_spec = torch.clamp(fres.amax(dim=-1), 0.05, 1.0)

        seed2, ur1, ur2 = rng_mod.rnd2(seed2)
        r1 = bn_r1 if i == 0 else ur1
        r2 = bn_r2 if i == 0 else ur2

        seed2, u_lobe = rng_mod.rnd(seed2)
        pick_spec = u_lobe < p_spec
        hvec = sample_ggx_vndf(n, v_view, roughness, r1, r2,
                               differentiable=cfg.differentiable, peeled=first)
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
        still = (c["active"] & surf.valid & ~stop_bright & ~trigger & ~die
                 & ~rr_die)
        return dict(
            i=i + 1,
            seed=seed2,
            ray_o=ray_o,
            ray_d=ray_d,
            throughput=throughput,
            radiance=radiance,
            active=still,
            prev_did_nee=prev_did_nee,
            pending=c["pending"] | trigger,
            f_pos=_sel3(trigger, surf.pos, c["f_pos"]),
            f_normal=_sel3(trigger, surf.normal, c["f_normal"]),
            f_albedo=_sel3(trigger, surf.albedo, c["f_albedo"]),
            f_rough=torch.where(trigger, roughness, c["f_rough"]),
            f_metal=torch.where(trigger, metallic, c["f_metal"]),
            f_view=_sel3(trigger, -c["ray_d"], c["f_view"]),
            f_throughput=_sel3(trigger, throughput, c["f_throughput"]),
        )

    # peel: the first round always runs, on pass 1's hit (pathtrace.py:
    # 355-362); the looped rounds trace incoherent batches.
    c = bounded_loop(
        lambda c: c["i"] < cfg.bounces and bool(c["active"].any()),
        lambda c: body(c, reuse=first_hit, first=True), c, cfg.bounces,
        cfg.differentiable, peel=1,
        loop_body=lambda c: body(c, coherent=False))
    radiance = c["radiance"]
    if use_restir:
        # Phase B's activations are recomputed in the backward pass of a
        # differentiable frame (ops/loops.checkpointed). A row-sharded
        # frame exchanges its windows first, so that the recompute posts
        # no message (parallel/halo.exchange_rows); the single-device call
        # keeps its arguments.
        sharded = (() if grid is None
                   else (grid, _reuse_windows(gbuf, r_di, r_gi, grid)))
        radiance = radiance + checkpointed(
            _spatial_reuse, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
            c["seed"], c, origins[0], frame_count, *sharded,
            enabled=cfg.differentiable)
        # Lane-local: it runs on a band that is a share of the
        # single-device frame (JAX's GSPMD-split training_step), and not in
        # the spmd frame, as pathtrace.py:371 has it.
        if (cfg.shadow_boundary_grads and cfg.differentiable
                and (grid is None or grid.whole_frame)):
            # The ReSTIR DI estimator estimates the same NEE area integral:
            # the term at the frozen first-rough hits, with the path
            # throughput (the diffuse integrand, pathtrace.py:371-388).
            radiance = radiance + _boundary_term(
                cfg, scene, lights, c["f_pos"], c["f_normal"], c["f_albedo"],
                c["pending"]) * c["f_throughput"].detach()
    # total_radiance = min(radiance, 10) (ray_gen_final.slang:430-431).
    return torch.clamp(radiance, max=cfg.radiance_clamp), c["i"]


def _boundary_term(cfg, scene, lights, pos, normal, albedo, nee_mask):
    """boundary.nee_boundary_term at these NEE lanes, its activations
    recomputed in the backward pass (ops/loops.checkpointed)."""
    if scene.edge_tri is None:
        raise ValueError(
            "cfg.shadow_boundary_grads needs scene edge topology — build "
            "the scene through boundary.with_edge_topology(scene)")
    return checkpointed(
        boundary.nee_boundary_term, scene, lights,
        scene.world_triangle_vertices(), pos, normal, albedo, nee_mask,
        4, cfg.shadow_boundary_candidates, enabled=cfg.differentiable)


def _shared_taps(frame_count, count, radius, salt):
    """Per-iteration shared disc offsets (cfg.spatial_taps == "shared",
    pathtrace.py:438-460): the reference's area-uniform disc
    (ray_gen_final.slang:164-167) drawn once per iteration from a
    frame-seeded scalar stream. Returns a list of (dx, dy) Python ints."""
    s = rng_mod.init_seed(torch.tensor(salt, dtype=torch.int64),
                          frame_count.to(torch.int64).cpu())
    taps = []
    for _ in range(count):
        s, ua, ur = rng_mod.rnd2(s)
        ang = ua * 2.0 * PI
        r = sqrt(ur) * radius
        taps.append((int((torch.cos(ang) * r).to(torch.int32)),
                     int((torch.sin(ang) * r).to(torch.int32))))
    return taps


def _disc_tap(px, py, seed, radius):
    """One per-pixel disc tap (pathtrace.py:617-624): two draws, the
    offset (cos, sin)(2 pi u) * sqrt(u') * radius truncated toward zero.
    fp.cos / fp.sin: torch's float32 functions differ between the CPU and
    the card. Returns (seed', nx, ny, dx, dy)."""
    seed, ua, ur = rng_mod.rnd2(seed)
    angle = ua * 2.0 * PI
    r = sqrt(ur) * radius
    dx = (fp.cos(angle) * r).to(torch.int32)
    dy = (fp.sin(angle) * r).to(torch.int32)
    return seed, px + dx, py + dy, dx, dy


def _perpixel_neighbour(nx, ny, w, h, fields, gnormal, gdepth, normal,
                        current_depth, grid=None):
    """perpixel_neighbor (pathtrace.py:513-534): the fields at the clamped
    flat index of (nx, ny) with the neighbour's G-buffer normal and depth;
    ok: on the image, normal within dot >= 0.9 (against the float32
    normal) and depth within 10%. Returns (fields', depth, ok). grid:
    nx, ny are global and fields, gnormal and gdepth the halo_s windows
    around the band; a source outside the window is not ok (the packed
    gather's in_halo, pathtrace.py:524-533, read from the windows that
    spatial reuse exchanged once rather than from one exchange a tap)."""
    inb = (nx >= 0) & (ny >= 0) & (nx < w) & (ny < h)
    ni = torch.clamp(ny.long() * w + nx.long(), 0, w * h - 1)
    if grid is not None:
        ni, in_halo = window_index(ni, grid.halo_s, grid)
        inb = inb & in_halo
    got = {k: v[ni] for k, v in fields.items()}
    nd = gdepth[ni]
    ok = (inb & (dot(normal, gnormal[ni]) >= 0.9)
          & (torch.abs(current_depth - nd) <= 0.1 * current_depth))
    return got, nd, ok


def _di_spatial_perpixel(cfg, lights, seed, r_di, pending, gbuf,
                         current_depth, pos, normal, shade, grid=None,
                         window=None):
    """DI spatial reuse with per-pixel taps, plain PyTorch as in JAX
    (pathtrace.py:600-652, 777-800): the centre merge, then per tap its
    offset draws, the fetch, the target function and its merge draw, and
    the resolve. grid: a band; window: the halo_s windows of r_di's
    fields (gbuf's normal and depth are windows too)."""
    w, h = cfg.width, cfg.height
    table, n_l = lights.table, lights.num
    attrs = (pos,) + tuple(shade)
    bf16 = cfg.shading_dtype == "bf16"
    keys = ("light_pos", "light_normal", "W", "M", "light_idx")
    pix = torch.arange(pos.shape[0], device=pos.device) + _pix0(grid, w)
    px, py = pix % w, pix // w
    center = {k: getattr(r_di, k) for k in keys}
    fields = center if window is None else {k: window[k] for k in keys}
    seed, r = cuda_restir.di_centre_merge(table, seed, center, pending, attrs,
                                          bf16=bf16)
    for _ in range(cfg.di_spatial_samples):
        seed, nx, ny, _, _ = _disc_tap(px, py, seed, cfg.di_spatial_radius)
        nr, _, ok = _perpixel_neighbour(nx, ny, w, h, fields, gbuf.normal,
                                        gbuf.depth, normal, current_depth,
                                        grid)
        w_cl = torch.clamp(nr["W"], max=cfg.di_temporal_w_clamp)
        m_cl = torch.clamp(nr["M"], max=cfg.di_temporal_m_clamp)
        use = pending & ok & (w_cl > 0.0) & (nr["light_idx"] < n_l)
        idx = torch.clamp(nr["light_idx"], max=n_l - 1)
        p_hat, _ = cuda_restir.eval_p_hat(table, idx, nr["light_pos"],
                                          nr["light_normal"], *attrs,
                                          bf16=bf16)
        seed, u = rng_mod.rnd(seed)
        w_sum, m_acc, take = cuda_restir.merge(r["w_sum"], r["M"], m_cl,
                                               p_hat * w_cl * m_cl, u, use)
        t3 = take[:, None]
        r = dict(w_sum=w_sum, M=m_acc,
                 light_idx=torch.where(take, idx, r["light_idx"]),
                 light_pos=torch.where(t3, nr["light_pos"], r["light_pos"]),
                 light_normal=torch.where(t3, nr["light_normal"],
                                          r["light_normal"]))
    return seed, cuda_restir.di_resolve(table, r, pending, attrs,
                                        cfg.di_spatial_w_clamp, bf16=bf16)


def _pix0(grid, w):
    """The global raster index of a band's first pixel (0: whole frame)."""
    return 0 if grid is None else grid.row0 * w


def _reuse_windows(gbuf, r_di, r_gi, grid):
    """Spatial reuse's windows: the G-buffer's normal and depth and every
    reservoir field, exchanged once with halo_s rows. Returns (gbuf with
    its guides as their windows, {DI field: window}, {GI field:
    window})."""
    di_keys = [f.name for f in dataclasses.fields(r_di)]
    gi_keys = [f.name for f in dataclasses.fields(r_gi)]
    ext = exchange_flat_many(
        [gbuf.normal, gbuf.depth] + [getattr(r_di, k) for k in di_keys]
        + [getattr(r_gi, k) for k in gi_keys], grid.halo_s, grid)
    return (gbuf._replace(normal=ext[0], depth=ext[1]),
            dict(zip(di_keys, ext[2:2 + len(di_keys)])),
            dict(zip(gi_keys, ext[2 + len(di_keys):])))


def _spatial_reuse(cfg, tracer, lights, mats, gbuf, r_di, r_gi, seed, c,
                   cam_origin, frame_count, grid=None, windows=None):
    """Phase B: ReSTIR DI + GI spatial reuse at the frozen first-rough hits
    (ray_gen_final.slang:136-327), shared or per-pixel taps. Returns
    radiance to add, (P, 3).

    grid: a row-sharded frame (pathtrace.py:464-615), with windows, the
    halo_s windows of _reuse_windows: K5 runs in its window form on them,
    the GI taps are cut from the windows (cuda_restir.shift_window) for
    K6, and per-pixel taps read the windows at global indices. Every
    other step is per lane on the band."""
    w, h = cfg.width, cfg.height
    p = c["pending"].shape[0]
    hl = p // w
    win = {}
    di_x = gi_x = None
    if grid is not None:
        # gbuf's guides as their windows from here on.
        win = dict(row0=grid.row0, halo=grid.halo_s, h_global=h)
        gbuf, di_x, gi_x = windows
    pending = c["pending"]
    pos, normal, albedo = c["f_pos"], c["f_normal"], c["f_albedo"]
    rough, metal, v_view = c["f_rough"], c["f_metal"], c["f_view"]
    throughput = c["f_throughput"]
    current_depth = vec_norm(pos - cam_origin)
    shared = cfg.spatial_taps == "shared"
    # The target functions read the attributes in cfg.shading_dtype; the
    # neighbour tests, rays and contributions the float32 ones.
    shade = shading_planes(cfg, normal, v_view, albedo, rough, metal)
    bf16 = cfg.shading_dtype == "bf16"

    # A differentiable frame keeps JAX's jnp merges (use_di_kernel,
    # pathtrace.py:722-725): K5 and K6 route no gradient.
    plain = cfg.differentiable
    # ---- DI spatial (ray_gen_final.slang:139-222), K5 ----
    if shared:
        di_taps = _shared_taps(frame_count, cfg.di_spatial_samples,
                               cfg.di_spatial_radius, 0x51A7D1)
        di_spatial = (
            functools.partial(cuda_restir.di_spatial_plain, bf16=bf16)
            if plain else cuda_restir.di_spatial)
        seed, di = di_spatial(
            lights.table, seed,
            {k: (getattr(r_di, k) if di_x is None else di_x[k])
             for k in ("light_pos", "light_normal", "W", "M", "light_idx")},
            di_taps, pending, gbuf.normal, gbuf.depth, current_depth, pos,
            *shade, w, hl,
            (cfg.di_temporal_w_clamp, cfg.di_temporal_m_clamp,
             cfg.di_spatial_w_clamp),
            **({"test_normal": normal} if bf16 else {}), **win,
        )
    else:
        seed, di = _di_spatial_perpixel(cfg, lights, seed, r_di, pending,
                                        gbuf, current_depth, pos, normal,
                                        shade, grid, di_x)
    # DI winner shadow ray, traced with the GI final visibility ray.
    sdir = di["light_pos"] - pos
    sdist = torch.clamp(vec_norm(sdir), min=1e-4)
    sdir = sdir / sdist[:, None]
    facing = dot(normal, sdir) > 0.0
    di_exclude = lights.world_tri[di["light_idx"].long()]

    # ---- GI spatial (ray_gen_final.slang:224-327): tap prep, K6 ----
    gi_shade = {"shade": (shade[0], shade[2], shade[4])} if bf16 else {}
    if shared:
        gi_taps = _shared_taps(frame_count, cfg.gi_spatial_samples,
                               cfg.gi_spatial_radius, 0x6E5B2F)
        taps = _gi_tap_prep(cfg, tracer, mats, gbuf, r_gi, gi_taps, pending,
                            pos, normal, current_depth, cam_origin, grid,
                            gi_x)
        gi_spatial = (
            functools.partial(cuda_restir.gi_spatial_plain, bf16=bf16)
            if plain else cuda_restir.gi_spatial)
        seed, gi = gi_spatial(
            seed,
            {k: getattr(r_gi, k) for k in ("sample_pos", "sample_radiance",
                                           "sample_tri", "w_sum", "M")},
            taps, pending, pos, normal, albedo, metal, cfg.gi_spatial_w_clamp,
            **gi_shade,
        )
    else:
        seed, gi = _gi_spatial_perpixel(cfg, tracer, mats, gbuf, r_gi, seed,
                                        pending, pos, normal, albedo, metal,
                                        current_depth, cam_origin, gi_shade,
                                        grid, gi_x)

    # One trace for the DI winner shadow ray and the GI final visibility
    # ray, then the adds in the reference's order (DI, then GI;
    # ray_gen_final.slang:203-222, 305-327).
    occ2 = trace_occluded(
        tracer, torch.cat([pos, pos]), torch.cat([sdir, gi["gdir"]]),
        torch.cat([sdist, gi["gdist"]]),
        exclude=torch.cat([di_exclude, gi["sample_tri"]]),
        coherent=False,
    )
    lit = di["has"] & facing & ~occ2[:p]
    radiance = torch.where(
        lit[:, None], di["f_y_w"] * throughput * di["w_spatial"][:, None], 0.0)
    ok_gi = gi["try_gi"] & ~occ2[p:]
    return radiance + torch.where(ok_gi[:, None],
                                  gi["contrib_pre"] * throughput, 0.0)


_GI_KEYS = ("sample_pos", "sample_radiance", "sample_tri", "W", "M")


def _gi_tap_geometry(cfg, mats, nr, n_depth, ok, nx, ny, pending, pos,
                     normal, cam_origin, pix0=0):
    """The geometry of one GI tap (pathtrace.py:833-898, every step but
    the fetch and the visibility trace): the W > 0 test and clamps, the
    neighbour's primary point x1 rebuilt from its depth, the reconnection
    Jacobian and the tests on it. nx, ny: a shared tap's offsets (ints)
    or each pixel's neighbour (int tensors). pix0: the global index of the
    lanes' first pixel (a band). Returns (nr clamped, ok with pending,
    jac, (gdir, d_new, sample_tri))."""
    w, h = cfg.width, cfg.height
    p = pos.shape[0]
    pix = torch.arange(p, device=pos.device) + pix0
    px, py = pix % w, pix // w
    proj_inverse = mats["proj_inverse"]
    view_inverse = mats["view_inverse"]
    inv_w = torch.tensor(1.0 / w, dtype=torch.float32).item()
    inv_h = torch.tensor(1.0 / h, dtype=torch.float32).item()
    ok = ok & (nr["W"] > 0.0)
    nr = dict(nr, W=torch.clamp(nr["W"], max=cfg.gi_temporal_w_clamp),
              M=torch.clamp(nr["M"], max=cfg.gi_spatial_m_clamp))

    # The neighbour's primary point x1 (ray_gen_final.slang:253-258),
    # rounded as camera.generate_rays is.
    ndx = ((px + nx if isinstance(nx, int) else nx).to(torch.float32)
           + 0.5) * inv_w * 2.0 - 1.0
    ndy = ((py + ny if isinstance(ny, int) else ny).to(torch.float32)
           + 0.5) * inv_h * 2.0 - 1.0
    tgt = [fma(proj_inverse[i, 0], ndx, proj_inverse[i, 1] * ndy)
           + proj_inverse[i, 2] + proj_inverse[i, 3] for i in range(3)]
    norm = sqrt(dot3(tgt[0], tgt[0], tgt[1], tgt[1], tgt[2], tgt[2]))
    tgt = [t / norm for t in tgt]
    ndir = torch.stack(
        [fma(view_inverse[i, 2], tgt[2],
             fma(view_inverse[i, 0], tgt[0], view_inverse[i, 1] * tgt[1]))
         for i in range(3)], dim=-1)
    neighbour_x1 = fma(ndir, n_depth[:, None], cam_origin)

    w_new = nr["sample_pos"] - pos
    w_old = nr["sample_pos"] - neighbour_x1
    d_new = torch.clamp(vec_norm(w_new), min=1e-4)
    d_old = torch.clamp(vec_norm(w_old), min=1e-4)
    n_x2 = nr["sample_normal"]
    cos_new = torch.clamp(dot(n_x2, -w_new / d_new[:, None]), min=0.0)
    cos_old = torch.clamp(dot(n_x2, -w_old / d_old[:, None]), min=0.0)
    ok = ok & (cos_new > 0.0) & (cos_old > 0.0)
    jac = (cos_new * d_old * d_old) / torch.clamp(
        cos_old * d_new * d_new, min=1e-4)
    jac = torch.clamp(jac, 0.0, cfg.gi_jacobian_clamp)
    gdir = w_new / d_new[:, None]
    ok = pending & ok & (dot(normal, gdir) > 0.0)
    return nr, ok, jac, (gdir, d_new, nr["sample_tri"])


def _gi_tap_prep(cfg, tracer, mats, gbuf, r_gi, gi_taps, pending, pos,
                 normal, current_depth, cam_origin, grid=None, window=None):
    """Every shared GI tap but its merge draw (pathtrace.py:833-898):
    neighbour fetch by whole-image shifts, validity, the geometry
    (_gi_tap_geometry), and one occlusion call for all T taps' visibility
    rays. Returns the (T, P[, 3]) planes K6 takes. grid: the band's taps,
    cut from the halo_s windows (window: r_gi's fields; gbuf's normal and
    depth are windows too) with the on-image test on global rows."""
    w, h = cfg.width, cfg.height
    p = pos.shape[0]
    hl = p // w
    dev = pos.device
    win = ({} if grid is None else
           dict(row0=grid.row0, halo=grid.halo_s, h_global=h))
    halo = win.get("halo", 0)
    src = ({k: getattr(r_gi, k) for k in _GI_KEYS + ("sample_normal",)}
           if window is None else window)
    planes = {k: [] for k in _GI_KEYS + ("jac", "ok")}
    rays = []
    for dx, dy in gi_taps:
        ok, n_depth = neighbour_ok(dx, dy, w, hl, normal, current_depth,
                                   gbuf.normal, gbuf.depth, **win)
        nr = {k: shift_window(src[k], dx, dy, w, hl, halo)
              for k in _GI_KEYS + ("sample_normal",)}
        ok = ok & (not (dx == 0 and dy == 0))
        nr, ok, jac, ray = _gi_tap_geometry(cfg, mats, nr, n_depth, ok, dx,
                                            dy, pending, pos, normal,
                                            cam_origin, _pix0(grid, w))
        rays.append(ray)
        for k in _GI_KEYS:
            planes[k].append(nr[k])
        planes["jac"].append(jac)
        planes["ok"].append(ok)
    t_n = len(gi_taps)
    if t_n:
        occ = trace_occluded(
            tracer, torch.cat([pos] * t_n), torch.cat([r[0] for r in rays]),
            torch.cat([r[1] for r in rays]),
            exclude=torch.cat([r[2] for r in rays]),
            coherent=False,
        )
        planes["ok"] = [ok & ~occ[k * p:(k + 1) * p]
                        for k, ok in enumerate(planes["ok"])]
        return {k: torch.stack(v).contiguous() for k, v in planes.items()}
    empty = {k: torch.zeros((0, p) + tuple(getattr(r_gi, k).shape[1:]),
                            dtype=getattr(r_gi, k).dtype, device=dev)
             for k in _GI_KEYS}
    empty["jac"] = torch.zeros((0, p), device=dev)
    empty["ok"] = torch.zeros((0, p), dtype=torch.bool, device=dev)
    return empty


def _gi_spatial_perpixel(cfg, tracer, mats, gbuf, r_gi, seed, pending, pos,
                         normal, albedo, metal, current_depth, cam_origin,
                         gi_shade, grid=None, window=None):
    """GI spatial reuse with per-pixel taps, plain PyTorch as in JAX
    (pathtrace.py:902-921, 1048-1075): per tap its offset draws, the
    fetch, the geometry, one visibility trace, the target function and
    the merge draw, in that order; then K6's plain resolve. grid, window:
    as in _di_spatial_perpixel."""
    w, h = cfg.width, cfg.height
    pix0 = _pix0(grid, w)
    pix = torch.arange(pos.shape[0], device=pos.device) + pix0
    px, py = pix % w, pix // w
    s_nrm, s_alb, s_met = gi_shade.get("shade", (normal, albedo, metal))
    fields = {k: (getattr(r_gi, k) if window is None else window[k])
              for k in _GI_KEYS + ("sample_normal",)}
    comb = {k: getattr(r_gi, k) for k in ("sample_pos", "sample_radiance",
                                          "sample_tri", "w_sum", "M")}
    for _ in range(cfg.gi_spatial_samples):
        seed, nx, ny, dx, dy = _disc_tap(px, py, seed, cfg.gi_spatial_radius)
        nr, n_depth, ok = _perpixel_neighbour(nx, ny, w, h, fields,
                                              gbuf.normal, gbuf.depth, normal,
                                              current_depth, grid)
        ok = ok & ~((dx == 0) & (dy == 0))
        nr, ok, jac, (gdir, gdist, tri) = _gi_tap_geometry(
            cfg, mats, nr, n_depth, ok, nx, ny, pending, pos, normal,
            cam_origin, pix0)
        ok = ok & ~trace_occluded(tracer, pos, gdir, gdist, exclude=tri)
        p_hat = gi_target_pdf(pos, s_nrm, s_alb, s_met, nr["sample_pos"],
                              nr["sample_radiance"],
                              bf16=cfg.shading_dtype == "bf16")
        seed, u = rng_mod.rnd(seed)
        w_sum, m_acc, take = cuda_restir.merge(
            comb["w_sum"], comb["M"], nr["M"], p_hat * nr["W"] * nr["M"] * jac,
            u, ok)
        t3 = take[:, None]
        comb = dict(
            w_sum=w_sum, M=m_acc,
            sample_tri=torch.where(take, nr["sample_tri"], comb["sample_tri"]),
            **{k: torch.where(t3, nr[k], comb[k])
               for k in ("sample_pos", "sample_radiance")})
    p = pos.shape[0]
    none = {k: torch.zeros((0, p) + tuple(comb[k].shape[1:]),
                           dtype=comb[k].dtype, device=pos.device)
            for k in ("sample_pos", "sample_radiance", "sample_tri")}
    none.update({k: torch.zeros((0, p), device=pos.device)
                 for k in ("W", "M", "jac")})
    none["ok"] = torch.zeros((0, p), dtype=torch.bool, device=pos.device)
    return cuda_restir.gi_spatial_plain(seed, comb, none, pending, pos,
                                        normal, albedo, metal,
                                        cfg.gi_spatial_w_clamp, **gi_shade,
                                        bf16=cfg.shading_dtype == "bf16")
