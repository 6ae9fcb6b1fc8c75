"""K3-K6: the ReSTIR merge kernels, each beside its plain PyTorch version.

Counterparts of sunray_tpu/ops/pallas_restir.py:

  K3 ris_audition   <- ris_audition_pallas (pallas_restir.py:291)
  K4 di_temporal    <- di_temporal_pallas  (pallas_restir.py:1044)
  K5 di_spatial     <- di_spatial_pallas   (pallas_restir.py:566)
  K6 gi_spatial     <- gi_spatial_pallas   (pallas_restir.py:791)

The kernels are in csrc/restir.cu. The plain versions are the JAX
package's jnp paths (render/restir.py ris_audition and
di_temporal_reuse, render/pathtrace.py's batched shared-tap branches),
formula for formula and with the reference's roundings (ops/brdf.py,
ops/fp.py). Each wrapper takes the plain version for CPU tensors and
launches its kernel for CUDA tensors; there is no other path.

With bf16 shading (cfg.shading_dtype="bf16") the surface attribute
planes the target functions read (normal, view, albedo, roughness,
metallic) come as bfloat16: the plain versions round as the JAX jnp
paths do (ops/brdf.py) and each wrapper launches its kernel's bf16
instantiation (the C entry points sunray_*_bf16), counted under
"<name>_bf16". K5 then also takes the float32 normal of its neighbour
test (test_normal) and K6 the bf16 planes of its target function
(shade) beside the float32 ones of its final ray and contribution.

Lights ride as a LightTable of (L, 3) float32 tensors. Seeds are int64
tensors holding uint32 values (ops/rng.py); light and triangle ids are
int32. What the TPU kernels computed through workarounds is read
directly here: the history reservoir at the reprojected index, the light
emission from the table, and the DI spatial neighbours at their shared
offsets.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sunray_tpu_torch.ops import cuda_build, fp
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import (
    INV_PI,
    dot,
    eval_p_hat_planar,
    eval_unshadowed_light,
    gi_target_pdf,
    gi_target_pdf_planar,
    luminance_max,
    safe_sqrt,
    vec_norm,
)
from sunray_tpu_torch.ops.cuda_gather import take_rows

MAX_TAPS = 8  # the kernels' per-launch tap bound (defaults: 5 DI, 3 GI)
# K3's table paths (csrc/restir.cu kRisSmemLights; checked against the
# library's sunray_ris_launch_shape when it loads): the records of up to
# RIS_SMEM_LIGHTS lights (64 bytes each) sit in shared memory, a larger
# table is read through the read-only cache.
RIS_SMEM_LIGHTS = 768


class LightTable(NamedTuple):
    v0: torch.Tensor        # (L, 3)
    v1: torch.Tensor        # (L, 3)
    v2: torch.Tensor        # (L, 3)
    emission: torch.Tensor  # (L, 3)

    @property
    def num(self) -> int:
        return self.v0.shape[0]


def _planes(x):
    """(..., 3) -> three (...) component planes."""
    return [x[..., 0], x[..., 1], x[..., 2]]


def _stack_sel(planes, slot, base):
    """planes (K, P) -> per lane planes[slot] where slot >= 0, else base."""
    got = torch.gather(planes, 0, slot.clamp(min=0).long()[None])[0]
    return torch.where(slot >= 0, got, base)


def _smooth_t(e0, e1, x):
    """clamp((x - e0) / (e1 - e0), 0, 1); the division by the constant is
    a multiply by its float32 reciprocal, as XLA compiles it."""
    inv = torch.tensor(1.0, dtype=torch.float32).div(
        torch.tensor(e1 - e0, dtype=torch.float32)).item()
    return torch.clamp((x - e0) * inv, 0.0, 1.0)


def smoothstep(e0, e1, x):
    """restir.py:711-713."""
    t = _smooth_t(e0, e1, x)
    return t * t * (3.0 - 2.0 * t)


def one_minus_smoothstep(e0, e1, x):
    """1 - smoothstep(e0, e1, x), the subtraction fused as XLA fuses it."""
    t = _smooth_t(e0, e1, x)
    return fp.fma(-(t * t), 3.0 - 2.0 * t, 1.0)


def eval_p_hat(table: LightTable, idx, light_pos, light_normal, pos, normal,
               view, albedo, rough, metal, bf16=False):
    """Lights.eval_p_hat (restir.py:167-176): (p_hat, f_y) of a stored
    sample, its emission read from the table at idx. bf16: as the target
    functions take it (ops/brdf.is_bf16), here and in the plain versions
    below."""
    f_y = eval_unshadowed_light(pos, normal, view, albedo, rough, metal,
                                take_rows(table.emission, idx), light_pos,
                                light_normal, bf16=bf16)
    return luminance_max(f_y), f_y


def merge(w_sum, m, new_m, weight, u, enable):
    """The accumulate-and-take core of merge_di / merge_gi
    (restir.py:94-124): returns (w_sum', M', take)."""
    m = m + torch.where(enable, new_m, 0.0)
    weight = torch.where(enable, weight, 0.0)
    w_sum = w_sum + weight
    take = enable & (u < weight / torch.clamp(w_sum, min=1e-4))
    return w_sum, m, take


# -- K3: RIS audition ---------------------------------------------------------

def ris_audition_plain(table: LightTable, seed, hit_pos, hit_normal, v_view,
                       albedo, roughness, metallic, candidates: int, enable,
                       bf16=False):
    """The jnp plane form of restir.ris_audition (restir.py:223-310): K
    candidates drawn uniformly over the light table and area-uniformly on
    the light, the sequential reservoir chain, and W for the winner."""
    p = hit_pos.shape[0]
    k = candidates
    n_l = table.num
    seed, draws = rng_mod.rnd_chain(seed, 4 * k)
    draws = draws.T
    u_pick, u1, u2, u_keep = draws[0::4], draws[1::4], draws[2::4], draws[3::4]
    idx = torch.clamp((u_pick * n_l).to(torch.int32), max=n_l - 1)   # (K, P)
    il = idx.long()
    v0 = _planes(take_rows(table.v0, il))
    v1 = _planes(take_rows(table.v1, il))
    v2 = _planes(take_rows(table.v2, il))
    em = _planes(take_rows(table.emission, il))
    e1 = [v1[a] - v0[a] for a in range(3)]
    e2 = [v2[a] - v0[a] for a in range(3)]
    cr = list(fp.cross3(e1, e2))
    cr_n = safe_sqrt(fp.sum3(cr, cr))
    area = 0.5 * cr_n
    nn = torch.clamp(cr_n, min=1e-12)
    nrm = [cr[a] / nn for a in range(3)]
    sqr1 = fp.sqrt(u1)
    bu = 1.0 - sqr1
    bv = u2 * sqr1
    bw = 1.0 - bu - bv
    pos = [fp.fma(v2[a], bw, fp.fma(v0[a], bu, v1[a] * bv)) for a in range(3)]

    p_hat, _, _ = eval_p_hat_planar(
        _planes(hit_pos), _planes(hit_normal), _planes(v_view),
        _planes(albedo), roughness, metallic, em, pos, nrm, bf16=bf16,
    )
    # p_hat / (1 / max(L * area, 1e-4)), which XLA folds to one multiply.
    wi = torch.where(enable[None, :],
                     p_hat * torch.clamp(n_l * area, min=1e-4), 0.0)

    w_sum = torch.zeros((p,), dtype=torch.float32, device=hit_pos.device)
    slot = torch.full((p,), -1, dtype=torch.int32, device=hit_pos.device)
    for i in range(k):
        w_sum = w_sum + wi[i]
        take = enable & (u_keep[i] < wi[i] / torch.clamp(w_sum, min=1e-4))
        slot = torch.where(take, i, slot)
    m = torch.where(enable, float(k), 0.0)
    zero = torch.zeros_like(w_sum)
    light_idx = _stack_sel(idx, slot, torch.zeros_like(slot))
    light_pos = torch.stack([_stack_sel(pl, slot, zero) for pl in pos], -1)
    light_normal = torch.stack([_stack_sel(pl, slot, zero) for pl in nrm], -1)

    p_hat_w, _ = eval_p_hat(table, light_idx, light_pos, light_normal,
                            hit_pos, hit_normal, v_view, albedo, roughness,
                            metallic, bf16=bf16)
    w = w_sum / torch.clamp(m * p_hat_w, min=1e-4)
    return seed, dict(
        light_pos=light_pos, light_normal=light_normal, w_sum=w_sum, M=m,
        light_idx=light_idx, W=torch.where(enable & (w_sum > 0.0), w, 0.0),
    )


# -- K4: DI temporal merge ----------------------------------------------------

def di_temporal_plain(table: LightTable, seed, r, hist, pi, ok, hit_pos,
                      hit_normal, v_view, albedo, roughness, metallic,
                      virtual_distance, m_clamp, w_clamp, bf16=False):
    """restir.di_temporal_reuse after the reprojection (restir.py:629-658):
    the history reservoir read at pi, confidence, one merge draw, W."""
    pil = pi.long()
    h_pos = hist["light_pos"][pil]
    h_nrm = hist["light_normal"][pil]
    h_m = torch.clamp(hist["M"][pil], max=m_clamp)
    h_w = torch.clamp(hist["W"][pil], max=w_clamp)
    h_idx = torch.clamp(hist["light_idx"][pil], max=table.num - 1)

    ndot = dot(hit_normal.float(), hist["hit_normal"][pil])
    depth_diff = (torch.abs(virtual_distance - hist["depth"][pil])
                  / torch.clamp(virtual_distance, min=1e-4))
    conf = (smoothstep(0.9, 0.99, ndot)
            * one_minus_smoothstep(0.05, 0.20, depth_diff))
    h_m = h_m * conf

    use = ok & (h_w > 0.0)
    p_hat_hist, _ = eval_p_hat(table, h_idx, h_pos, h_nrm, hit_pos,
                               hit_normal, v_view, albedo, roughness, metallic,
                               bf16=bf16)
    seed, u_m = rng_mod.rnd(seed)
    w_sum, m, take = merge(r["w_sum"], r["M"], h_m, p_hat_hist * h_w * h_m,
                           u_m, use)
    t3 = take[:, None]
    light_idx = torch.where(take, h_idx, r["light_idx"])
    light_pos = torch.where(t3, h_pos, r["light_pos"])
    light_normal = torch.where(t3, h_nrm, r["light_normal"])
    p_hat_m, _ = eval_p_hat(table, light_idx, light_pos, light_normal,
                            hit_pos, hit_normal, v_view, albedo, roughness,
                            metallic, bf16=bf16)
    w_new = w_sum / torch.clamp(m * p_hat_m, min=1e-4)
    return seed, dict(
        light_pos=light_pos, light_normal=light_normal, w_sum=w_sum, M=m,
        light_idx=light_idx, W=torch.where(use, w_new, r["W"]),
    )


# -- K5: DI spatial merge -----------------------------------------------------

def shift_flat(x, dx, dy, h, w):
    """Field at pixel + (dx, dy) for every pixel, by a roll of the image
    view (pathtrace.py:398-404). The roll wraps: callers mask lanes whose
    neighbour is off the image."""
    img = x.reshape((h, w) + tuple(x.shape[1:]))
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)).reshape(x.shape)


def shift_window(x, dx, dy, width, height, halo=0):
    """shift_flat of a band of `height` rows whose field x is a window
    extended by `halo` rows above and below (a row-sharded frame,
    parallel/halo.py): lane i reads the window at pixel + (dx, dy), the
    row slice of shift_flat_ext (halo.py:192-201), |dy| <= halo. halo 0:
    shift_flat of the whole frame."""
    if halo == 0:
        return shift_flat(x, dx, dy, height, width)
    if abs(dy) > halo:
        raise ValueError(f"shift dy={dy} beyond the {halo}-row halo")
    rest = tuple(x.shape[1:])
    img = x.reshape((height + 2 * halo, width) + rest)
    sl = torch.roll(img[halo + dy:halo + dy + height], shifts=-dx, dims=1)
    return sl.reshape((height * width,) + rest)


def window_rows(x, width, height, halo=0):
    """The band's own lanes of a field held as a halo window."""
    return x if halo == 0 else x[halo * width:(halo + height) * width]


def neighbour_ok(dx, dy, width, height, normal, current_depth, gnormal,
                 gdepth, row0=0, halo=0, h_global=None):
    """Shared-tap neighbour test (pathtrace.py:583-599): on the image, its
    G-buffer normal within dot >= 0.9 and its depth within 10%. Returns
    (ok, neighbour depth). row0, halo, h_global: a band of `height` rows
    at global row row0 of an h_global-row image, its guides a halo window
    (shift_window); the on-image test takes global rows."""
    pix = torch.arange(normal.shape[0], device=normal.device)
    nx = pix % width + dx
    ny = pix // width + dy + row0
    hg = height if h_global is None else h_global
    inb = (nx >= 0) & (ny >= 0) & (nx < width) & (ny < hg)
    nn = shift_window(gnormal, dx, dy, width, height, halo)
    nd = shift_window(gdepth, dx, dy, width, height, halo)
    ok = (inb & (dot(normal, nn) >= 0.9)
          & (torch.abs(current_depth - nd) <= 0.1 * current_depth))
    return ok, nd


def di_centre_merge(table: LightTable, seed, center, pending, attrs,
                    bf16=False):
    """The centre merge of DI spatial reuse (pathtrace.py:777-788): the
    pixel's own pass-1 reservoir into an empty one, one draw. attrs:
    (hit_pos, normal, view, albedo, roughness, metallic) as the target
    function takes them. Returns (seed', the merged reservoir's w_sum, M,
    light_idx, light_pos, light_normal)."""
    n_l = table.num
    zero = torch.zeros((pending.shape[0],), dtype=torch.float32,
                       device=pending.device)
    c_ok = pending & (center["W"] > 0.0) & (center["light_idx"] < n_l)
    c_idx = torch.clamp(center["light_idx"], max=n_l - 1)
    p_hat_c, _ = eval_p_hat(table, c_idx, center["light_pos"],
                            center["light_normal"], *attrs, bf16=bf16)
    seed, u_m = rng_mod.rnd(seed)
    w_sum, m_acc, take = merge(zero, zero, center["M"],
                               p_hat_c * center["W"] * center["M"], u_m, c_ok)
    t3 = take[:, None]
    return seed, dict(w_sum=w_sum, M=m_acc,
                      light_idx=torch.where(take, c_idx, 0),
                      light_pos=torch.where(t3, center["light_pos"], 0.0),
                      light_normal=torch.where(t3, center["light_normal"], 0.0))


def di_resolve(table: LightTable, r, pending, attrs, w_spatial_clamp,
               bf16=False):
    """The resolve of DI spatial reuse (pathtrace.py:789-800): has, the
    clamped w_spatial and the winner's f_y, beside r's fields."""
    has = pending & (r["w_sum"] > 0.0)
    p_hat_w, f_y_w = eval_p_hat(table, r["light_idx"], r["light_pos"],
                                r["light_normal"], *attrs, bf16=bf16)
    w_spatial = torch.clamp(
        r["w_sum"] / torch.clamp(r["M"] * p_hat_w, min=1e-3),
        max=w_spatial_clamp)
    return dict(r, w_spatial=w_spatial, f_y_w=f_y_w, has=has)


def di_spatial_plain(table: LightTable, seed, center, taps, pending, gnormal,
                     gdepth, current_depth, hit_pos, hit_normal, v_view,
                     albedo, roughness, metallic, width, height, clamps,
                     test_normal=None, bf16=False, row0=0, halo=0,
                     h_global=None):
    """DI spatial reuse at the frozen hits (pathtrace.py:780-801 with the
    batched shared taps of :646-720): the centre merge (one draw), the T
    tap merges (rnd_chain(T)), the resolve with the w_spatial clamp, and
    the winner's f_y. clamps: (w_clamp, m_clamp, w_spatial_clamp).
    hit_normal ... metallic: the target function's attributes (float32 or,
    with bf16 shading, bfloat16); test_normal: the float32 normal of the
    neighbour test (default hit_normal).

    The window form (a row-sharded frame, pathtrace.py:464-615): the
    lanes are a band of `height` rows at global row row0 of an
    h_global-row image, and center, gnormal and gdepth are a window of
    height + 2 * halo rows around it (parallel/halo.exchange_flat)."""
    w_clamp, m_clamp, w_spatial_clamp = clamps
    n_l = table.num
    p = hit_pos.shape[0]
    attrs = (hit_pos, hit_normal, v_view, albedo, roughness, metallic)
    if test_normal is None:
        test_normal = hit_normal

    window = dict(row0=row0, halo=halo, h_global=h_global)
    own = {k: window_rows(v, width, height, halo) for k, v in center.items()}
    seed, r = di_centre_merge(table, seed, own, pending, attrs, bf16=bf16)
    w_sum, m_acc = r["w_sum"], r["M"]
    light_idx, light_pos, light_normal = (r["light_idx"], r["light_pos"],
                                          r["light_normal"])

    t_n = len(taps)
    if t_n:
        fields = [[shift_window(center[k], dx, dy, width, height, halo)
                   for k in ("light_idx", "W", "M", "light_pos",
                             "light_normal")]
                  for dx, dy in taps]
        okp = torch.stack([
            neighbour_ok(dx, dy, width, height, test_normal, current_depth,
                         gnormal, gdepth, **window)[0] for dx, dy in taps])
        idx_raw = torch.stack([f[0] for f in fields])
        w_cl = torch.clamp(torch.stack([f[1] for f in fields]), max=w_clamp)
        m_cl = torch.clamp(torch.stack([f[2] for f in fields]), max=m_clamp)
        lpos = torch.stack([f[3] for f in fields])            # (T, P, 3)
        lnrm = torch.stack([f[4] for f in fields])
        use_p = pending[None] & okp & (w_cl > 0.0) & (idx_raw < n_l)
        idx_cl = torch.clamp(idx_raw, max=n_l - 1)
        p_hat_p, _, _ = eval_p_hat_planar(
            _planes(hit_pos), _planes(hit_normal), _planes(v_view),
            _planes(albedo), roughness, metallic,
            _planes(take_rows(table.emission, idx_cl)), _planes(lpos),
            _planes(lnrm), bf16=bf16,
        )
        seed, u_taps = rng_mod.rnd_chain(seed, t_n)
        u_taps = u_taps.T
        slot = torch.full((p,), -1, dtype=torch.int32, device=hit_pos.device)
        for i in range(t_n):
            w_sum, m_acc, take = merge(w_sum, m_acc, m_cl[i],
                                       p_hat_p[i] * w_cl[i] * m_cl[i],
                                       u_taps[i], use_p[i])
            slot = torch.where(take, i, slot)
        light_idx = _stack_sel(idx_cl, slot, light_idx)
        light_pos = torch.stack([_stack_sel(lpos[..., a], slot,
                                            light_pos[:, a])
                                 for a in range(3)], -1)
        light_normal = torch.stack([_stack_sel(lnrm[..., a], slot,
                                               light_normal[:, a])
                                    for a in range(3)], -1)

    return seed, di_resolve(
        table, dict(light_pos=light_pos, light_normal=light_normal,
                    w_sum=w_sum, M=m_acc, light_idx=light_idx),
        pending, attrs, w_spatial_clamp, bf16=bf16)


# -- K6: GI spatial merge -----------------------------------------------------

def gi_spatial_plain(seed, center, taps, pending, hit_pos, hit_normal, albedo,
                     metallic, w_clamp, shade=None, bf16=False):
    """GI spatial merge and final resolve (pathtrace.py:989-1073): taps are
    the prepared neighbours as (T, P[, 3]) planes (sample_pos,
    sample_radiance, sample_tri, W, M, jac, ok). hit_normal, albedo,
    metallic: float32, for the final ray and contribution; shade: the
    target function's (normal, albedo, metallic) where they differ (bf16
    shading), else these."""
    p = hit_pos.shape[0]
    s_nrm, s_alb, s_met = shade or (hit_normal, albedo, metallic)
    w_sum = center["w_sum"]
    m_acc = center["M"]
    t_n = taps["W"].shape[0]
    spos = taps["sample_pos"]
    srad = taps["sample_radiance"]
    slot = torch.full((p,), -1, dtype=torch.int32, device=hit_pos.device)
    if t_n:
        p_hat_p = gi_target_pdf_planar(
            _planes(hit_pos), _planes(s_nrm), _planes(s_alb), s_met,
            _planes(spos), _planes(srad), bf16=bf16,
        )
        seed, u_taps = rng_mod.rnd_chain(seed, t_n)
        u_taps = u_taps.T
        for i in range(t_n):
            w_sum, m_acc, take = merge(
                w_sum, m_acc, taps["M"][i],
                p_hat_p[i] * taps["W"][i] * taps["M"][i] * taps["jac"][i],
                u_taps[i], taps["ok"][i])
            slot = torch.where(take, i, slot)

    def sel(name):
        base = center[name]
        if not t_n:
            return base
        if base.dim() == 1:
            return _stack_sel(taps[name], slot, base)
        return torch.stack([_stack_sel(taps[name][..., a], slot, base[:, a])
                            for a in range(3)], -1)

    s_pos = sel("sample_pos")
    s_rad = sel("sample_radiance")
    s_tri = sel("sample_tri")
    p_hat_f = gi_target_pdf(hit_pos, s_nrm, s_alb, s_met, s_pos, s_rad,
                            bf16=bf16)
    # w_sum / max(M, 1) / max(p_hat, 1e-9), which XLA folds to one division.
    w_gi = torch.where(
        p_hat_f > 1e-3,
        w_sum / (torch.clamp(m_acc, min=1.0) * torch.clamp(p_hat_f, min=1e-9)),
        0.0,
    )
    w_gi = torch.clamp(w_gi, max=w_clamp)
    gvec = s_pos - hit_pos
    gdist = torch.clamp(vec_norm(gvec), min=1e-4)
    gdir = gvec / gdist[:, None]
    gndl = torch.clamp(dot(hit_normal, gdir), min=0.0)
    try_gi = pending & (w_gi > 0.0) & (gndl > 0.0)
    f_diffuse = albedo * (1.0 - metallic[:, None]) * INV_PI
    contrib_pre = s_rad * f_diffuse * (gndl * w_gi)[:, None]
    return seed, dict(gdir=gdir, gdist=gdist, sample_tri=s_tri,
                      try_gi=try_gi, contrib_pre=contrib_pre)


# -- wrappers -------------------------------------------------------------------

_P = ctypes.c_void_p


def _f32(name, *tensors):
    for t in tensors:
        cuda_build.require_dtype(name, t, torch.float32)


def _attr_planes(name, *tensors) -> bool:
    """The target function's attribute planes, all float32 or all bfloat16
    (bf16 shading); returns True for bfloat16."""
    bf16 = tensors[0].dtype == torch.bfloat16
    for t in tensors:
        cuda_build.require_dtype(name, t,
                                 torch.bfloat16 if bf16 else torch.float32)
    return bf16


def _entry(kernels, name, bf16):
    """The library's entry point of K3-K6 `name`, its bf16 instantiation
    with bf16 attribute planes."""
    return getattr(kernels, f"sunray_{name}_bf16" if bf16 else f"sunray_{name}")


def _count(name, bf16):
    """Count a launch of the port's own library: the bf16 instantiations
    under their own names."""
    cuda_build.launches[f"{name}_bf16" if bf16 else name] += 1


def _check_lanes(name, p, **tensors):
    for key, t in tensors.items():
        if t.shape[0] != p:
            raise cuda_build.KernelError(f"{name}: {key} has {t.shape[0]} "
                                         f"lanes, expected {p}")


def _vec3(name, *tensors):
    for t in tensors:
        if t.dim() != 2 or t.shape[1] != 3:
            raise cuda_build.KernelError(f"{name}: expected (N, 3), got "
                                         f"{tuple(t.shape)}")


def _check_table(name, table: LightTable):
    cuda_build.require_cuda(name, *table)
    _f32(name, *table)
    _vec3(name, *table)
    if table.num < 1:
        raise cuda_build.KernelError(f"{name}: empty light table")


def _seed_arg(name, seed):
    cuda_build.require_dtype(name, seed, torch.int64)
    return seed


def _mask(t):
    """A bool mask as the uint8 array the kernels read. Callers keep the
    result in a variable until the launch: a temporary freed inside the
    argument list goes back to the allocator, and the next one can be
    placed over it before the kernel has read it."""
    return t.to(torch.uint8).contiguous()


def _out(p, dev, *shapes_dtypes):
    return [torch.empty((p, *shape), dtype=dt, device=dev)
            for shape, dt in shapes_dtypes]


_RES_OUT = (((3,), torch.float32), ((3,), torch.float32), ((), torch.float32),
            ((), torch.float32), ((), torch.int32), ((), torch.float32))


def _res_dict(light_pos, light_normal, w_sum, m, light_idx, w):
    return dict(light_pos=light_pos, light_normal=light_normal, w_sum=w_sum,
                M=m, light_idx=light_idx, W=w)


def ris_audition(table: LightTable, seed, hit_pos, hit_normal, v_view, albedo,
                 roughness, metallic, candidates: int, enable):
    """K3. Returns (seed', reservoir fields dict) as ris_audition_plain."""
    args = (seed, hit_pos, hit_normal, v_view, albedo, roughness, metallic,
            enable)
    if cuda_build.on_cpu(*table, *args):
        return ris_audition_plain(table, seed, hit_pos, hit_normal, v_view,
                                  albedo, roughness, metallic, candidates,
                                  enable)
    name = "ris_audition"
    p = hit_pos.shape[0]
    cuda_build.require_cuda(name, *table, *args)
    _f32(name, hit_pos)
    _attr_planes(name, hit_normal, v_view, albedo, roughness, metallic)
    _vec3(name, hit_pos, hit_normal, v_view, albedo)
    _check_lanes(name, p, seed=_seed_arg(name, seed), hit_normal=hit_normal,
                 v_view=v_view, albedo=albedo, roughness=roughness,
                 metallic=metallic, enable=enable)
    _check_table(name, table)
    return _launch_audition(table, seed, hit_pos, hit_normal, v_view, albedo,
                            roughness, metallic, candidates, enable)


def _launch_audition(table: LightTable, seed, hit_pos, hit_normal, v_view,
                     albedo, roughness, metallic, candidates, enable, lib=None):
    """K3 once on checked arguments, from `lib` (default: the port's
    library, whose launches are counted). The entry point computes each
    light's 64-byte record into `rec` (one small launch), then auditions."""
    p, dev = hit_pos.shape[0], hit_pos.device
    # (L, 12) rows v0, v1, v2, emission: 48 bytes a light.
    tab = torch.cat(tuple(table), dim=1).contiguous()
    rec = torch.empty((table.num, 16), dtype=torch.float32, device=dev)
    en = _mask(enable)
    seed_out = torch.empty_like(seed)
    outs = _out(p, dev, *_RES_OUT)
    kernels = cuda_build.library() if lib is None else lib
    bf16 = hit_normal.dtype == torch.bfloat16
    err = _entry(kernels, "ris_audition", bf16)(
        tab.data_ptr(), table.num, rec.data_ptr(), seed.data_ptr(),
        hit_pos.data_ptr(), hit_normal.data_ptr(), v_view.data_ptr(),
        albedo.data_ptr(), roughness.data_ptr(), metallic.data_ptr(),
        en.data_ptr(), p, candidates, seed_out.data_ptr(),
        *(o.data_ptr() for o in outs), cuda_build.stream_ptr(),
    )
    cuda_build.check_launch("ris_audition", err)
    if lib is None:
        _count("ris_audition", bf16)
    return seed_out, _res_dict(*outs)


def di_temporal(table: LightTable, seed, r, hist, pi, ok, hit_pos, hit_normal,
                v_view, albedo, roughness, metallic, virtual_distance, m_clamp,
                w_clamp):
    """K4. r: the audition reservoir (light_pos, light_normal, w_sum, M,
    light_idx, W); hist: last frame's reservoir (light_pos, light_normal,
    W, M, light_idx, hit_normal, depth) over the whole frame, read at pi
    (int64, in range); ok: the reprojection mask. Returns (seed', fields)."""
    r_keys = ("light_pos", "light_normal", "w_sum", "M", "light_idx", "W")
    h_keys = ("light_pos", "light_normal", "W", "M", "light_idx",
              "hit_normal", "depth")
    lanes = (seed, hit_pos, hit_normal, v_view, albedo, roughness, metallic,
             virtual_distance, pi, ok, *(r[k] for k in r_keys))
    if cuda_build.on_cpu(*table, *lanes, *(hist[k] for k in h_keys)):
        return di_temporal_plain(table, seed, r, hist, pi, ok, hit_pos,
                                 hit_normal, v_view, albedo, roughness,
                                 metallic, virtual_distance, m_clamp, w_clamp)
    name = "di_temporal"
    p = hit_pos.shape[0]
    dev = cuda_build.require_cuda(name, *table, *lanes,
                                  *(hist[k] for k in h_keys))
    _f32(name, hit_pos, virtual_distance,
         *(r[k] for k in r_keys if k != "light_idx"),
         *(hist[k] for k in h_keys if k != "light_idx"))
    bf16 = _attr_planes(name, hit_normal, v_view, albedo, roughness, metallic)
    cuda_build.require_dtype(name, r["light_idx"], torch.int32)
    cuda_build.require_dtype(name, hist["light_idx"], torch.int32)
    cuda_build.require_dtype(name, pi, torch.int64)
    _check_lanes(name, p, seed=_seed_arg(name, seed), pi=pi, ok=ok,
                 virtual_distance=virtual_distance,
                 **{f"r.{k}": r[k] for k in r_keys})
    n_hist = hist["W"].shape[0]
    _check_lanes(name, n_hist, **{f"hist.{k}": hist[k] for k in h_keys})
    _check_table(name, table)
    ok8 = _mask(ok)
    seed_out = torch.empty_like(seed)
    outs = _out(p, dev, *_RES_OUT)
    err = _entry(cuda_build.library(), "di_temporal", bf16)(
        table.emission.data_ptr(), table.num, seed.data_ptr(),
        *(r[k].data_ptr() for k in r_keys),
        *(hist[k].data_ptr() for k in h_keys), n_hist,
        pi.data_ptr(), ok8.data_ptr(), hit_pos.data_ptr(),
        hit_normal.data_ptr(), v_view.data_ptr(), albedo.data_ptr(),
        roughness.data_ptr(), metallic.data_ptr(), virtual_distance.data_ptr(),
        p, ctypes.c_float(m_clamp), ctypes.c_float(w_clamp),
        seed_out.data_ptr(), *(o.data_ptr() for o in outs),
        cuda_build.stream_ptr(),
    )
    cuda_build.check_launch(name, err)
    _count(name, bf16)
    return seed_out, _res_dict(*outs)


def _taps_arg(name, taps):
    if len(taps) > MAX_TAPS:
        raise cuda_build.KernelError(f"{name}: {len(taps)} taps > {MAX_TAPS}")
    flat = [int(v) for tap in taps for v in tap]
    flat += [0] * (2 * MAX_TAPS - len(flat))
    return (ctypes.c_int * (2 * MAX_TAPS))(*flat)


def di_spatial(table: LightTable, seed, center, taps, pending, gnormal, gdepth,
               current_depth, hit_pos, hit_normal, v_view, albedo, roughness,
               metallic, width, height, clamps, test_normal=None, row0=0,
               halo=0, h_global=None):
    """K5. center: the pass-1 DI reservoir over the whole frame (light_pos,
    light_normal, W, M, light_idx); taps: list of shared (dx, dy) offsets;
    gnormal/gdepth: the G-buffer guides of the neighbour test. The kernel
    reads each neighbour in place. hit_normal ... metallic: the target
    function's attributes, float32 or bfloat16 (bf16 shading, which also
    takes the float32 test_normal for the neighbour test). Returns (seed',
    fields) as di_spatial_plain.

    row0, halo, h_global: K5's window form (a row-sharded frame): the
    lanes are a band of `height` rows at global row row0 of an
    h_global-row image; center, gnormal and gdepth are its window of
    height + 2 * halo rows. Launched through sunray_di_spatial_window and
    counted as "di_spatial_window"; halo 0, row0 0 and h_global = height
    is the whole frame's kernel."""
    c_keys = ("light_pos", "light_normal", "W", "M", "light_idx")
    lanes = (seed, pending, gnormal, gdepth, current_depth, hit_pos,
             hit_normal, v_view, albedo, roughness, metallic,
             *(center[k] for k in c_keys))
    if cuda_build.on_cpu(*table, *lanes):
        return di_spatial_plain(table, seed, center, taps, pending, gnormal,
                                gdepth, current_depth, hit_pos, hit_normal,
                                v_view, albedo, roughness, metallic, width,
                                height, clamps, test_normal, row0=row0,
                                halo=halo, h_global=h_global)
    name = "di_spatial"
    p = hit_pos.shape[0]
    if p != width * height:
        raise cuda_build.KernelError(f"{name}: {p} lanes for {width}x{height}")
    n_win = (height + 2 * halo) * width
    if halo < 0 or (halo > 0 and any(abs(dy) > halo for _, dy in taps)):
        raise cuda_build.KernelError(f"{name}: taps {taps} leave the "
                                     f"{halo}-row window")
    cuda_build.require_cuda(name, *table, *lanes)
    _f32(name, gnormal, gdepth, current_depth, hit_pos,
         *(center[k] for k in c_keys if k != "light_idx"))
    if _attr_planes(name, hit_normal, v_view, albedo, roughness, metallic):
        if test_normal is None:
            raise cuda_build.KernelError(f"{name}: bf16 attributes need the "
                                         "float32 test_normal")
        cuda_build.require_cuda(name, test_normal, hit_pos)
        _f32(name, test_normal)
        _vec3(name, test_normal)
        _check_lanes(name, p, test_normal=test_normal)
    cuda_build.require_dtype(name, center["light_idx"], torch.int32)
    _check_lanes(name, p, seed=_seed_arg(name, seed), pending=pending,
                 current_depth=current_depth)
    _check_lanes(name, n_win, gnormal=gnormal, gdepth=gdepth,
                 **{f"center.{k}": center[k] for k in c_keys})
    _check_table(name, table)
    window = None
    if (row0, halo, h_global) != (0, 0, None):
        window = (halo, row0, height if h_global is None else h_global)
    return _launch_di_spatial(table, seed, center, taps, pending, gnormal,
                              gdepth, current_depth, hit_pos, hit_normal,
                              v_view, albedo, roughness, metallic, width,
                              height, clamps, test_normal=test_normal,
                              window=window)


def _launch_di_spatial(table: LightTable, seed, center, taps, pending, gnormal,
                       gdepth, current_depth, hit_pos, hit_normal, v_view,
                       albedo, roughness, metallic, width, height, clamps,
                       lib=None, test_normal=None, window=None):
    """K5 once on checked arguments, from `lib` (default: the port's
    library, whose launches are counted); the bf16 instantiation for
    bf16 attributes, with test_normal. window: (halo, row0, h_global),
    K5's window form (sunray_di_spatial_window)."""
    name = "di_spatial" if window is None else "di_spatial_window"
    c_keys = ("light_pos", "light_normal", "W", "M", "light_idx")
    p, dev = hit_pos.shape[0], hit_pos.device
    w_clamp, m_clamp, w_spatial_clamp = clamps
    pending8 = _mask(pending)
    seed_out = torch.empty_like(seed)
    outs = _out(p, dev, *_RES_OUT[:5], ((), torch.float32),
                ((3,), torch.float32), ((), torch.bool))
    kernels = cuda_build.library() if lib is None else lib
    bf16 = hit_normal.dtype == torch.bfloat16
    err = _entry(kernels, name, bf16)(
        table.emission.data_ptr(), table.num, seed.data_ptr(),
        *(center[k].data_ptr() for k in c_keys), pending8.data_ptr(),
        gnormal.data_ptr(), gdepth.data_ptr(), current_depth.data_ptr(),
        hit_pos.data_ptr(), hit_normal.data_ptr(), v_view.data_ptr(),
        albedo.data_ptr(), roughness.data_ptr(), metallic.data_ptr(),
        *((test_normal.data_ptr(),) if bf16 else ()), width, height,
        *(window or ()), _taps_arg(name, taps), len(taps),
        ctypes.c_float(w_clamp), ctypes.c_float(m_clamp),
        ctypes.c_float(w_spatial_clamp), seed_out.data_ptr(),
        *(o.data_ptr() for o in outs), cuda_build.stream_ptr(),
    )
    cuda_build.check_launch(name, err)
    if lib is None:
        _count(name, bf16)
    light_pos, light_normal, w_sum, m, light_idx, w_spatial, f_y_w, has = outs
    return seed_out, dict(light_pos=light_pos, light_normal=light_normal,
                          w_sum=w_sum, M=m, light_idx=light_idx,
                          w_spatial=w_spatial, f_y_w=f_y_w, has=has)


def gi_spatial(seed, center, taps, pending, hit_pos, hit_normal, albedo,
               metallic, w_clamp, shade=None):
    """K6. center: the pass-1 GI reservoir (sample_pos, sample_radiance,
    sample_tri, w_sum, M); taps: prepared (T, P[, 3]) planes (sample_pos,
    sample_radiance, sample_tri, W, M, jac, ok); hit_normal, albedo,
    metallic: float32; shade: the target function's bfloat16 (normal,
    albedo, metallic) with bf16 shading (the bf16 instantiation), else
    None. Returns (seed', dict(gdir, gdist, sample_tri, try_gi,
    contrib_pre))."""
    c_keys = ("sample_pos", "sample_radiance", "sample_tri", "w_sum", "M")
    t_keys = ("sample_pos", "sample_radiance", "sample_tri", "W", "M", "jac",
              "ok")
    lanes = (seed, pending, hit_pos, hit_normal, albedo, metallic,
             *(center[k] for k in c_keys), *(taps[k] for k in t_keys),
             *(shade or ()))
    if cuda_build.on_cpu(*lanes):
        return gi_spatial_plain(seed, center, taps, pending, hit_pos,
                                hit_normal, albedo, metallic, w_clamp, shade)
    name = "gi_spatial"
    p = hit_pos.shape[0]
    t_n = taps["W"].shape[0]
    if t_n > MAX_TAPS:
        raise cuda_build.KernelError(f"{name}: {t_n} taps > {MAX_TAPS}")
    dev = cuda_build.require_cuda(name, *lanes)
    _f32(name, hit_pos, hit_normal, albedo, metallic,
         *(center[k] for k in c_keys if k != "sample_tri"),
         *(taps[k] for k in t_keys if k not in ("sample_tri", "ok")))
    cuda_build.require_dtype(name, center["sample_tri"], torch.int32)
    cuda_build.require_dtype(name, taps["sample_tri"], torch.int32)
    if shade is not None:
        for t in shade:
            cuda_build.require_dtype(name, t, torch.bfloat16)
        _vec3(name, shade[0], shade[1])
        _check_lanes(name, p, **dict(zip(("shade.normal", "shade.albedo",
                                          "shade.metallic"), shade)))
    _check_lanes(name, p, seed=_seed_arg(name, seed), pending=pending,
                 **{f"center.{k}": center[k] for k in c_keys})
    for k in t_keys:
        if tuple(taps[k].shape[:2]) != (t_n, p):
            raise cuda_build.KernelError(f"{name}: taps.{k} is "
                                         f"{tuple(taps[k].shape)}")
    ok8, pending8 = _mask(taps["ok"]), _mask(pending)
    seed_out = torch.empty_like(seed)
    outs = _out(p, dev, ((3,), torch.float32), ((), torch.float32),
                ((), torch.int32), ((), torch.bool), ((3,), torch.float32))
    bf16 = shade is not None
    err = _entry(cuda_build.library(), name, bf16)(
        seed.data_ptr(),
        *(center[k].data_ptr() for k in c_keys),
        *(taps[k].data_ptr() for k in t_keys if k != "ok"),
        ok8.data_ptr(), t_n, pending8.data_ptr(),
        hit_pos.data_ptr(), hit_normal.data_ptr(), albedo.data_ptr(),
        metallic.data_ptr(), *(t.data_ptr() for t in shade or ()), p,
        ctypes.c_float(w_clamp), seed_out.data_ptr(),
        *(o.data_ptr() for o in outs), cuda_build.stream_ptr(),
    )
    cuda_build.check_launch(name, err)
    _count(name, bf16)
    gdir, gdist, s_tri, try_gi, contrib_pre = outs
    return seed_out, dict(gdir=gdir, gdist=gdist, sample_tri=s_tri,
                          try_gi=try_gi, contrib_pre=contrib_pre)
